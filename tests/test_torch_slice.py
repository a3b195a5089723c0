"""The whole inference slice: the port's ``predict`` against the JAX
package's ``model.predict`` on the same numpy image, with the JAX weights
carried over by ``convert.py``.

R50 depth at narrow widths, 5 classes, float32, a 128x160 image. On the CPU
the JAX model takes its XLA paths (the NMS sweep, the XLA pooler), which are
the references of the two kernels. Tolerance: both sides run float32 convs
with different summation orders (XLA vs oneDNN), so continuous outputs agree
to about 1e-5 relative; integer outputs (validity, classes, which boxes
survive NMS and in which slot) must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import (
    _RCNNDrivers,
    _build_rcnn_parts,
)
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.meta_arch.postprocess import (
    detector_postprocess,
)
from test_torch_config import narrow_cfgs

H, W = 128, 160
SIZES = np.array([[128, 160], [112, 150]], np.int32)
RTOL, ATOL = 1e-4, 1e-4


def tame_variables(variables):
    """numpy copy of the JAX variables with activations kept small: the
    stem's FrozenBN scale 1/640, every bottleneck's last one 0.2 (the port's
    own ``init_weights`` rule)."""
    v = jax.tree_util.tree_map(np.asarray, variables)
    v = jax.tree_util.tree_map(np.array, v)  # writable copies
    frozen = v["frozen"]["backbone"]
    frozen["stem"]["conv1"]["FrozenBatchNorm_0"]["scale"][:] = 1.0 / 640
    for stage, blocks in frozen.items():
        if stage.startswith("res"):
            for block in blocks.values():
                block["conv3"]["FrozenBatchNorm_0"]["scale"][:] = 0.2
    return v


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = narrow_cfgs()
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    batch = {"image": jnp.asarray(image), "image_size": jnp.asarray(SIZES)}
    jmodel = jax_build_model(jcfg)
    variables = tame_variables(jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch))
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.predict)(variables, batch))
    tmodel = build_model(tcfg, state_dict=convert_variables(variables))
    tbatch = {"image": torch.from_numpy(image), "image_size": torch.from_numpy(SIZES)}
    tout = tmodel.predict(tbatch)
    return jcfg, tcfg, variables, batch, tbatch, jmodel, tmodel, jout, tout


def test_slice_detections_match_jax(pair):
    *_, jout, tout = pair
    valid = tout.is_valid.numpy()
    np.testing.assert_array_equal(valid, jout.is_valid)
    assert valid.sum() >= 100  # the mask path pools real boxes
    np.testing.assert_array_equal(tout.pred_classes.numpy(), jout.pred_classes)
    np.testing.assert_allclose(tout.boxes.numpy(), jout.boxes, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tout.scores.numpy(), jout.scores, rtol=RTOL, atol=1e-6)


def test_slice_masks_match_jax(pair):
    *_, jout, tout = pair
    masks = tout.pred_masks.numpy()
    assert masks.shape == jout.pred_masks.shape == (2, 100, 28, 28)
    np.testing.assert_allclose(masks, jout.pred_masks, rtol=RTOL, atol=1e-5)


def test_slice_proposals_match_jax(pair):
    """RPN proposals (top-k, decode, NMS keep decisions) slot by slot."""
    jcfg, _, variables, batch, tbatch, _, tmodel, _, _ = pair
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))

    def props(v, b):
        _, logits, deltas = drv.features_and_rpn(v, b, False)
        return drv.rpn.proposals(logits, deltas, b["image_size"], training=False)

    jp = jax.tree_util.tree_map(np.asarray, jax.jit(props)(variables, batch))
    with torch.no_grad():
        feats = tmodel.features(tbatch["image"])
        rpn = tmodel.proposal_generator
        logits, deltas = rpn.rpn_head([feats[f] for f in rpn.in_features])
        tp = rpn.proposals(logits, deltas, tbatch["image_size"])
    np.testing.assert_array_equal(tp.is_valid.numpy(), jp.is_valid)
    assert tp.is_valid.numpy().sum() > 500
    np.testing.assert_allclose(tp.proposal_boxes.numpy(), jp.proposal_boxes,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp.objectness_logits.numpy(), jp.objectness_logits,
                               rtol=RTOL, atol=1e-5)


def test_postprocess_conventional_matches_jax(pair):
    """Mask pasting (soft, then the ``conventional`` uint8 format) against the
    JAX package, on the slice's detected boxes with soft masks spread over
    [0, 1] (random-weight mask logits all sit at 0.5)."""
    from detectron2_tensorflow_tpu.models.meta_arch.postprocess import (
        detector_postprocess as jax_postprocess,
    )
    from detectron2_tensorflow_tpu.structures import Instances as JaxInstances
    from detectron2_tensorflow_tpu.structures.masks import (
        paste_masks_in_image as jax_paste,
    )
    from detectron2_tensorflow_tpu_torch.structures.masks import paste_masks_in_image

    jcfg, tcfg, _, batch, tbatch, _, _, _, tout = pair
    masks = np.random.default_rng(1).uniform(0, 1, (2, 100, 28, 28)).astype(np.float32)
    boxes = tout.boxes.numpy()
    soft_t = paste_masks_in_image(torch.from_numpy(masks[0]), tout.boxes[0], (H, W), -1.0)
    soft_j = np.asarray(jax_paste(jnp.asarray(masks[0]), jnp.asarray(boxes[0]), (H, W), -1.0))
    np.testing.assert_allclose(soft_t.numpy(), soft_j, rtol=1e-5, atol=1e-6)

    det = tout.replace(pred_masks=torch.from_numpy(masks))
    got = detector_postprocess(tcfg, det, tbatch).pred_masks.numpy()
    jdet = JaxInstances(boxes=jnp.asarray(boxes), pred_masks=jnp.asarray(masks))
    want = np.asarray(jax_postprocess(jcfg, jdet, batch).pred_masks)
    assert got.shape == want.shape == (2, 100, H, W) and got.dtype == np.uint8
    # Exact, except where the soft value lies within float32 noise of 0.5.
    clear = np.abs(soft_j - 0.5) > 1e-5
    np.testing.assert_array_equal(got[0][clear], want[0][clear])
    np.testing.assert_array_equal(got[1], want[1])
    assert got.sum() > 1000
