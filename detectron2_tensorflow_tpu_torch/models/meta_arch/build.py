"""``build_model(cfg)``: the port's counterpart of the JAX package's builder."""

from __future__ import annotations

import torch

from .rcnn import DTYPES, GeneralizedRCNN, init_weights


def build_model(cfg, device="cpu", generator: torch.Generator | None = None,
                state_dict=None, training: bool = False) -> GeneralizedRCNN:
    """Build the model on ``device``, computing in ``cfg.MODEL.DTYPE``.

    Weights come from ``state_dict`` (for example ``convert.py``'s output)
    or, without one, from :func:`init_weights` drawn from ``generator``
    (seed 0 when none is given). For serving (eval mode) parameters are
    stored in the model dtype; for ``training`` they stay float32 and each
    layer casts them to its input's dtype, as the JAX package keeps float32
    parameters. The FrozenBN buffers stay float32, as the JAX package folds
    them in float32. On CUDA the weights are put in ``channels_last`` layout.
    """
    model = GeneralizedRCNN(cfg)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(model, generator)
    model.train(training)
    if not training:
        dtype = DTYPES[cfg.MODEL.DTYPE]
        with torch.no_grad():
            for p in model.parameters():
                p.data = p.data.to(dtype)
    model.to(device)
    if torch.device(device).type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model
