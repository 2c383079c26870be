"""Tracing (the port of llamatpu/utils/profiling.py): `trace(profile_dir)`
records what runs inside it with torch.profiler, the host's operators and, on
the card, every kernel launch with its device time, and writes one Chrome
trace (`trace.json`, viewable in Perfetto or chrome://tracing) into the
directory. The JAX package's `dump_decode_hlo` writes XLA's compiled program;
the port runs no XLA program, so it has no counterpart.
"""
from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def trace(profile_dir: str | None):
    """Capture a trace into `profile_dir`/trace.json (nothing when None)."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
