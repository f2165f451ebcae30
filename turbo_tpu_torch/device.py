"""Device choice for the port: the card, or the CPU only when asked."""
from __future__ import annotations

import torch


def pick_device(platform: str = "") -> torch.device:
    """``cuda:0`` when no platform is named (raises without CUDA); the
    CPU only for ``-platform cpu``. No watchdog, no fallback."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in ("", "cuda", "gpu"):
        raise ValueError(f"unknown platform {platform!r} (cuda | cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: turbo_tpu_torch runs on the GPU "
                           "(pass -platform cpu to run the plain torch "
                           "versions on the CPU)")
    return torch.device("cuda:0")
