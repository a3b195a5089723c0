"""The GN Mask R-CNN (``configs/Misc/mask_rcnn_R_50_FPN_3x_gn.yaml``) against
the JAX package: ``test_torch_norms_syncbn.py``'s tests and ``step``
fixture, collected here on this file's ``pair`` (the GN YAML's models), so
that each YAML's models are built and compiled on a worker of their own.
"""

import pytest

from test_torch_norms_syncbn import (  # noqa: F401  (collected here, on this file's pair)
    step,
    test_bn_affine_is_in_the_norm_group_as_jax,
    test_norm_models_load_converted_weights_by_name,
    test_norm_models_predict_matches_jax,
    test_norm_models_train_step_gradients_match_jax,
    test_norm_models_train_step_losses_match_jax,
    test_norm_models_train_step_update_matches_optax,
    test_predict_reads_running_statistics_in_a_training_model,
    test_syncbn_train_step_moves_every_running_statistic_as_jax,
    make_pair,
)
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=["gn"])
def pair(request):
    return make_pair(request.param)
