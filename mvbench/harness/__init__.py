"""The harness: cells, frames, window, trace, check, runner."""
