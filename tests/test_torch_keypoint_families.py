"""Keypoint R-CNN's head on the other ROI-head families, the C4 YAML's
``Res5ROIHeads`` and the cascade's ``CascadeROIHeads``, against the JAX
package (moved from ``test_torch_keypoint.py``, the longest file of the
CPU suite, to spread it over the workers). Widths and tolerances are
``test_torch_keypoint.py``'s.
"""

import numpy as np
import pytest

from detectron2_tensorflow_tpu_torch.convert import convert_variables
import test_torch_c4 as c4
from test_torch_c4 import ATOL, LOSS_RTOL, RTOL, check_detections, yaml_cfgs
from test_torch_keypoint import BIAS
from test_torch_train import MASK_LOSS_RTOL, assert_grad_close
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("family", ["c4", "cascade"])
def test_keypoints_on_c4_and_cascade_match_jax(family):
    """``KEYPOINT_ON`` on the C4 YAML (``Res5ROIHeads``: the keypoint
    pooler on the res4 plane) and the cascade's (``CascadeROIHeads``), each
    head pooling its ROIs on its own as the JAX package does: the
    keypoints of ``predict`` slot by slot (x, y 1e-4, scores 1e-5), the
    losses to 1e-5 (the mask loss 3e-4) and the keypoint head's gradients to
    1e-4 of their largest magnitude (the deconv bias's, zero, aside)."""
    path, extra = {"c4": (c4.C4_YAML, {}),
                   "cascade": ("configs/Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml",
                               {"MODEL.NECK.OUT_CHANNELS": 32})}[family]
    kw = {"MODEL.KEYPOINT_ON": True, "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS": (32, 32), **extra}
    p = c4.predict_pair(*yaml_cfgs(path, **kw))
    check_detections(p)
    got, want = p["tout"].pred_keypoints.numpy(), p["jout"].pred_keypoints
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-5)
    run = c4.train_pair(*yaml_cfgs(path, **kw, **{"INPUT.MAX_GT_INSTANCES": 5,
                                                  "SOLVER.IMS_PER_BATCH": 2}))
    assert set(run["t_losses"]) == set(run["j_losses"]) and "loss_keypoint" in run["t_losses"]
    for k, v in run["t_losses"].items():
        np.testing.assert_allclose(v, run["j_losses"][k], rtol=MASK_LOSS_RTOL if k == "loss_mask"
                                   else LOSS_RTOL, err_msg=k)
    want = convert_variables({"params": run["j_grads"]})
    heads = [n for n in want if n.startswith("roi_heads.keypoint_head.") and n != BIAS]
    assert len(heads) == 5
    for name in heads:
        assert_grad_close(run["t_grads"][name], want[name].numpy(), name)
