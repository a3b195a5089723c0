"""Relation Networks' ``predict`` against the JAX package with the duplicate
removal's ``max`` rule and with ``MASK_ON``: ``test_torch_relation_predict.py``'s
checks (valid slots and classes equal, boxes 1e-4, scores 1e-4 relative,
masks 1e-5, the pooling and NMS calls of a ``predict``) on this file's
fixture.
"""

import pytest

from test_torch_config import one_torch_thread  # noqa: F401 (autouse)
from test_torch_c4 import predict_pair
from test_torch_relation import relation_cfgs
from test_torch_relation_predict import (  # noqa: F401 (collected here on this file's fixture)
    SETTINGS,
    test_relation_detections_match_jax,
    test_relation_masks_match_jax,
    test_relation_predict_calls,
)


@pytest.fixture(scope="module", params=["dup_max", "dup_mask"])
def relation(request):
    return predict_pair(*relation_cfgs(**SETTINGS[request.param]))
