"""Where the time of one training step goes on the card.

    python -m detectron2_tensorflow_tpu_torch.tools.profile_train [batch ...]

Builds chip_smoke's training state (Mask R-CNN R50-FPN at ``train_cfg``:
bf16, float32 parameters, seeded random weights), steps on a seeded
800x1344 ``make_train_batch`` of each given size (default 8), and prints:
images/s on the host clock around synchronized steps, the peak device
memory, and from ``torch.profiler`` the device time per step, the device's
idle share, the device time by category (as ``profile_predict``) and the top
kernels. The full profiler table goes to ``profile_train_b<batch>.txt``
beside ``profile_predict``'s.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

from detectron2_tensorflow_tpu_torch import build_model, train_cfg
from detectron2_tensorflow_tpu_torch.engine import (
    build_train_step,
    create_train_state,
    make_train_batch,
)
from detectron2_tensorflow_tpu_torch.tools import profile_predict


def run(batch: int, out_dir: Path) -> None:
    dev = torch.device("cuda", 0)
    cfg = train_cfg(batch)
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(0),
                        training=True)
    state = create_train_state(cfg, model, torch.Generator(device=dev).manual_seed(0))
    step = build_train_step(cfg, state)
    data = {k: torch.from_numpy(v).to(dev) for k, v in make_train_batch(cfg).items()}
    for _ in range(2):
        step(data)
    torch.cuda.synchronize()

    iters = 6
    t0 = time.perf_counter()
    for _ in range(iters):
        step(data)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters
    print(f"batch {batch}: {batch / wall:.2f} img/s, {wall * 1000:.2f} ms/step (host clock), "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    profile_predict.profile(lambda: step(data), 3, f"batch {batch}",
                            out_dir / f"profile_train_b{batch}.txt")


def main(argv) -> None:
    profile_predict.main(argv, run, default_batch=8)


if __name__ == "__main__":
    main(sys.argv[1:])
