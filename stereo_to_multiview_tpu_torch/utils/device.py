"""Device report (the reference's printDeviceInfo, cuda_utils.h:50-83)
and the kernels' build ahead of the first frame.

The JAX package persists its compiled executables
(`enable_compilation_cache`); the port's compiled artifacts are the CUDA
kernel libraries, cached by source hash under the package's `_build/`.
`enable_compilation_cache` builds every missing one before the first
frame, so no frame pays the build (a cold build of all sources takes
tens of seconds), and says so.
"""

from __future__ import annotations

import subprocess
import time

import torch


def _power_limit() -> str | None:
    """`name, power.limit` from nvidia-smi, or None where it does not
    answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


def print_device_info(device=None) -> None:
    """Print the torch device's name and memory, and the card's power
    limit where nvidia-smi answers."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    print("---------------------------")
    print("-- DEVICE INFO --")
    print("---------------------------")
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        props = torch.cuda.get_device_properties(idx)
        print(f"Device {idx}: {props.name} (CUDA {torch.version.cuda}, "
              f"sm_{props.major}{props.minor}, "
              f"{props.multi_processor_count} SMs)")
        print(f"  memory: {props.total_memory / 2**30:.1f} GiB")
        smi = _power_limit()
        if smi:
            print(f"  nvidia-smi name, power.limit: {smi}")
    else:
        print(f"Device: {dev} (torch {torch.__version__}, plain versions "
              f"of the kernels)")
    print("---------------------------\n")


def enable_compilation_cache(device=None) -> dict:
    """On a CUDA device, build every CUDA kernel library that is not in
    the cache yet (`kernels.build_kernels`) and say how long it took;
    returns the build logs.  On the CPU nothing is built."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return {}
    from stereo_to_multiview_tpu_torch import kernels
    t0 = time.perf_counter()
    logs = kernels.build_kernels()
    if logs:
        print(f"built {len(logs)} CUDA kernel libraries in "
              f"{time.perf_counter() - t0:.1f} s (cached for later runs)")
    else:
        print("CUDA kernel libraries: all built already")
    return logs
