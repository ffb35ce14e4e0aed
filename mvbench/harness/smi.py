"""The card's power limit, clocks and power, read with `nvidia-smi` (which
reads the card and sets nothing) for the card the run uses, named by its
UUID.  Answers None where it does not answer."""

from __future__ import annotations

import os
import statistics
import subprocess
import threading

FIELDS = ("clocks.sm", "clocks.mem", "power.draw", "temperature.gpu")


def gpu_id(index: int) -> str:
    """nvidia-smi's name of CUDA device `index` of this process: its UUID,
    else its entry of CUDA_VISIBLE_DEVICES, else the index."""
    import torch
    try:
        uuid = str(torch.cuda.get_device_properties(index).uuid)
    except (AttributeError, RuntimeError):
        uuid = ""
    if uuid:
        return uuid if uuid.startswith(("GPU-", "MIG-")) else "GPU-" + uuid
    visible = [v.strip() for v in
               os.environ.get("CUDA_VISIBLE_DEVICES", "").split(",")]
    return visible[index] if index < len(visible) and visible[index] \
        else str(index)


def query(fields: str, gpu: str) -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "-i", gpu,
                              f"--query-gpu={fields}",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def power_limit_w(gpu: str) -> float | None:
    line = query("power.limit", gpu)
    try:
        return float(line) if line else None
    except ValueError:
        return None


class Sampler:
    """`nvidia-smi` sampling card `gpu` every `ms` milliseconds in a child
    process from `start()` to `stop()`, which ends the child and waits for
    it."""

    def __init__(self, gpu: str, ms: int = 1000):
        self.gpu = gpu
        self.ms = ms
        self.rows: list = []
        self.proc = None
        self.thread = None

    def start(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "-i", self.gpu,
                 "--query-gpu=" + ",".join(FIELDS),
                 "--format=csv,noheader,nounits", f"-lms={self.ms}"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        except OSError:
            return self
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()
        return self

    def _read(self):
        for line in self.proc.stdout:
            try:
                vals = [float(x) for x in line.split(",")]
            except ValueError:
                continue
            if len(vals) == len(FIELDS):
                self.rows.append(vals)

    def stop(self) -> dict | None:
        """{field: [min, median, max]} over the samples, None without
        any."""
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
            self.thread.join(timeout=10)
            self.proc.stdout.close()
        if not self.rows:
            return None
        cols = list(zip(*self.rows))
        return {f: [min(c), statistics.median(c), max(c)]
                for f, c in zip(FIELDS, cols)}
