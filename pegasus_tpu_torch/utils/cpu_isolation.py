"""CPU isolation: keep a process off the card.

Every code path that must stay CPU-only (tests, tools run beside a
serving process) needs the same step BEFORE torch first initializes
CUDA: hide the devices from the process, and optionally prove the
isolation held.

Shared here so that one site breaks loudly if the isolation stops
holding, instead of a forgotten copy silently opening a context on the
card.
"""

from __future__ import annotations


def force_cpu(verify: bool = False) -> None:
    """Hide every CUDA device from this process. Call before the first
    CUDA initialization.

    verify=True proves the isolation actually held: it FAILS LOUDLY if
    torch still sees a device (CUDA was initialized before the call).
    """
    import os

    os.environ["CUDA_VISIBLE_DEVICES"] = ""

    if verify:
        import torch

        if torch.cuda.is_available():
            raise RuntimeError(
                "CPU isolation failed: torch still sees "
                f"{torch.cuda.device_count()} CUDA device(s); CUDA was "
                "initialized before force_cpu")
