"""``build_model(cfg)``: the port's counterpart of the JAX package's builder."""

from __future__ import annotations

import torch
from torch import nn

from ..layers import BatchNorm2d, GroupNorm
from .common import DTYPES
from .rcnn import init_weights, meta_architecture


def build_model(cfg, device="cuda", generator: torch.Generator | None = None,
                state_dict=None, training: bool = False,
                init: str = "serving") -> nn.Module:
    """Build the model on ``device`` (the card unless the caller passes
    ``device="cpu"``; without a card that raises), computing in
    ``cfg.MODEL.DTYPE``: the ``GeneralizedRCNN``, ``ProposalNetwork``,
    ``SingleStageDetector``, ``PanopticFPN`` or ``SemanticSegmentor`` that
    ``MODEL.META_ARCHITECTURE`` names.

    Weights come from ``state_dict`` (for example ``convert.py``'s output)
    or, without one, from :func:`init_weights` drawn from ``generator``
    (seed 0 when none is given) by the recipe ``init`` names ("serving", or
    "jax": the JAX package's own initializers, which training from scratch
    uses). For serving (eval mode) parameters are stored in the model dtype
    but GN's and BN's, which compute in float32; for ``training`` they stay float32
    and each layer casts them to its input's dtype, as the JAX package keeps
    float32 parameters. The FrozenBN buffers stay float32, as the JAX
    package folds them in float32, and so do BN's running statistics and
    RetinaNet's ``loss_normalizer``. On CUDA the weights are put in ``channels_last`` layout.
    A model whose training is not ported (Relation Networks) raises
    ``NotImplementedError`` for ``training``.
    """
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: no CUDA device; pass device='cpu' to build on the CPU")
    model = meta_architecture(cfg)(cfg)
    if training and getattr(model, "training_not_ported", None):
        raise NotImplementedError(model.training_not_ported)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    else:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(model, generator, init)
    model.train(training)
    if not training:
        dtype = DTYPES[cfg.MODEL.DTYPE]
        keep = {id(p) for m in model.modules() if isinstance(m, (GroupNorm, BatchNorm2d))
                for p in m.parameters()}
        with torch.no_grad():
            for p in model.parameters():
                if id(p) not in keep:
                    p.data = p.data.to(dtype)
    model.to(device)
    if torch.device(device).type == "cuda":
        model.to(memory_format=torch.channels_last)
    return model
