"""The port's fused bottleneck tail (``ops/fused_residual.py``) against the
JAX package's ``ops/pallas/fused_residual.py``, on the CPU.

Inputs come from a seeded numpy generator and go to both sides. The plain
version is held against the Pallas kernel run in interpret mode, as
``tests/test_fused_residual.py`` runs it: both sum float32 products in some
order and round once, so float32 agrees to 1e-5 of the largest value and
bfloat16 to one bf16 ulp of each value. The JAX package's CPU forward
(``_reference``) rounds to bf16 after the product, the affine and the add,
so against it bf16 is held to that test's 0.05. Gradients go through the
port's ``autograd.Function`` and ``jax.grad`` of the JAX ``custom_vjp``, in
float32, to 1e-5 of each tensor's largest value.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import R50_TAILS
from detectron2_tensorflow_tpu.models.backbones.resnet import BottleneckBlock as JaxBottleneck
from detectron2_tensorflow_tpu.ops.pallas import fused_residual as jfr
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.models.backbones.resnet import (
    BottleneckBlock,
    build_resnet_backbone,
)
from detectron2_tensorflow_tpu_torch.ops import fused_residual as tfr
from test_torch_config import narrow_cfgs

SWITCH = tfr.ENV_SWITCH
F32_TOL = 1e-5
JAX_REFERENCE_BF16_TOL = 0.05  # tests/test_fused_residual.py: per-step rounding vs one rounding


def _inputs(b=2, h=5, w=7, k=64, n=256, seed=0):
    """b*h*w = 70 rows by default: not a multiple of any tile."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, w, k)).astype(np.float32),
            (rng.standard_normal((k, n)) * 0.1).astype(np.float32),
            (rng.uniform(0, 1, n) + 0.5).astype(np.float32),
            (rng.standard_normal(n) * 0.2).astype(np.float32),
            rng.standard_normal((b, h, w, n)).astype(np.float32))


def _port_args(x, w2d, scale, shift, sc, dtype):
    """NHWC numpy -> the port's layouts: x and shortcut NCHW views of NHWC
    memory (channels_last), the weight [N, K, 1, 1]."""
    def nchw(a):
        return torch.from_numpy(a).to(dtype).permute(0, 3, 1, 2)
    weight = torch.from_numpy(np.ascontiguousarray(w2d.T)).to(dtype)[:, :, None, None]
    return nchw(x), weight, torch.from_numpy(scale), torch.from_numpy(shift), nchw(sc)


def _bf16_ulp(v):
    """One bf16 ulp at each |v| (8 significant bits)."""
    mag = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def _round(a, dtype):
    return np.array(jnp.asarray(a, dtype).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_pallas_interpret(dtype):
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    x, w2d, scale, shift, sc = _inputs()
    x, w2d, sc = _round(x, jdt), _round(w2d, jdt), _round(sc, jdt)
    ss = jnp.stack([jnp.asarray(scale), jnp.asarray(shift)])
    want = np.asarray(jfr._launch(jnp.asarray(x, jdt), jnp.asarray(w2d, jdt), ss,
                                  jnp.asarray(sc, jdt), interpret=True).astype(jnp.float32))
    out = tfr.fused_conv1x1_bn_add_relu_reference(*_port_args(x, w2d, scale, shift, sc, tdt))
    assert out.dtype == tdt and out.shape == (2, 256, 5, 7)
    assert out.is_contiguous(memory_format=torch.channels_last)
    got = out.float().permute(0, 2, 3, 1).numpy()
    err = np.abs(got - want)
    if dtype == "float32":
        assert err.max() <= F32_TOL * np.abs(want).max()
    else:
        assert (err <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))).all()
    # The wrapper takes the plain version for CPU tensors.
    again = tfr.fused_conv1x1_bn_add_relu(*_port_args(x, w2d, scale, shift, sc, tdt))
    assert torch.equal(again, out)


def test_reference_matches_jax_unfused_reference_bf16():
    x, w2d, scale, shift, sc = _inputs()
    x, w2d, sc = (_round(a, jnp.bfloat16) for a in (x, w2d, sc))
    want = np.asarray(jfr._reference(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w2d)[None, None],
                                     jnp.asarray(scale), jnp.asarray(shift),
                                     jnp.asarray(sc, jnp.bfloat16)).astype(jnp.float32))
    got = tfr.fused_conv1x1_bn_add_relu_reference(
        *_port_args(x, w2d, scale, shift, sc, torch.bfloat16)).float().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=JAX_REFERENCE_BF16_TOL,
                               rtol=JAX_REFERENCE_BF16_TOL)


def test_gradients_match_jax_custom_vjp():
    x, w2d, scale, shift, sc = _inputs(b=1, h=4, w=4, k=32, n=64, seed=1)

    def jloss(xx, kernel, shortcut):
        out = jfr.fused_conv1x1_bn_add_relu(xx, kernel, jnp.asarray(scale), jnp.asarray(shift),
                                            shortcut)
        return jnp.sum(out * jnp.cos(out))

    jdx, jdw, jdsc = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(w2d)[None, None], jnp.asarray(sc))
    tx, tw, tscale, tshift, tsc = _port_args(x, w2d, scale, shift, sc, torch.float32)
    tx, tw, tsc = (t.detach().requires_grad_(True) for t in (tx, tw, tsc))
    out = tfr.fused_conv1x1_bn_add_relu(tx, tw, tscale, tshift, tsc)
    (out * torch.cos(out)).sum().backward()
    for name, got, want in (
        ("dx", tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jdx)),
        ("dW", tw.grad[:, :, 0, 0].numpy().T, np.asarray(jdw)[0, 0]),
        ("dshortcut", tsc.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jdsc)),
    ):
        assert got.shape == want.shape, name
        assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max(), name
    assert (tsc.grad == 0).any() and (tsc.grad != 0).any()  # the ReLU gate is exercised


@pytest.mark.parametrize("value", [None, "", "0", "1", "yes"])
def test_predicates_and_gate_match_jax(monkeypatch, value):
    if value is None:
        monkeypatch.delenv(SWITCH, raising=False)
    else:
        monkeypatch.setenv(SWITCH, value)
    assert tfr.fused_epilogue_enabled() == bool(value)
    grid = [(k, s, g, d, norm, bias, pad)
            for k in (1, 3) for s in (1, 2) for g in (1, 2) for d in (1, 2)
            for norm in ("FrozenBN", "", "GN") for bias in (False, True)
            for pad in ("SAME", "VALID", [(1, 1), (1, 1)])]
    for args in grid:
        assert tfr.epilogue_shape_supported(*args) == jfr.epilogue_shape_supported(*args), args
        assert tfr.fused_epilogue_supported(*args) == jfr.fused_epilogue_supported(*args), args
    assert any(tfr.fused_epilogue_supported(*a) for a in grid) == bool(value)


def test_wrapper_refuses_other_devices():
    args = _port_args(*_inputs(b=1, h=2, w=2, k=8, n=16), torch.float32)
    with pytest.raises(RuntimeError):
        tfr.fused_conv1x1_bn_add_relu(*(t.to("meta") for t in args))


def test_switch_read_at_build_keeps_state_dict_keys(monkeypatch):
    _, tcfg = narrow_cfgs()
    monkeypatch.delenv(SWITCH, raising=False)
    off = build_resnet_backbone(tcfg)
    monkeypatch.setenv(SWITCH, "1")
    on = build_resnet_backbone(tcfg)
    monkeypatch.delenv(SWITCH)  # read once, at build: the model keeps its choice
    assert list(on.state_dict()) == list(off.state_dict())
    for model, fused in ((off, False), (on, True)):
        convs = {n: m for n, m in model.named_modules() if hasattr(m, "fuse_residual")}
        tails = [n for n, m in convs.items() if m.fuse_residual]
        assert tails == ([f"res{s}.{i}.conv3" for s, k in zip(range(2, 6), (3, 4, 6, 3))
                          for i in range(k)] if fused else [])
    assert len(tails) == 16


@pytest.mark.parametrize("stride,has_shortcut,cin", [(1, True, 16), (1, False, 32), (2, True, 16)])
def test_bottleneck_block_matches_jax_with_switch_on(monkeypatch, stride, has_shortcut, cin):
    """The port's ``BottleneckBlock`` with the fused tail against the JAX
    package's with the switch on (its ``custom_vjp`` in the trace), weights
    through ``convert.py``; float32, 1e-5 of the largest value."""
    monkeypatch.setenv(SWITCH, "1")
    rng = np.random.default_rng(stride * 10 + cin)
    x = rng.standard_normal((2, 8, 10, cin)).astype(np.float32)
    jblock = JaxBottleneck(out_channels=32, bottleneck_channels=8, stride=stride,
                           has_shortcut=has_shortcut)
    variables = jax.tree_util.tree_map(np.array, jblock.init(jax.random.PRNGKey(0), x))
    for leaf in jax.tree_util.tree_leaves(variables["frozen"]):
        leaf[:] = rng.uniform(0.5, 1.5, leaf.shape)
    jaxpr = str(jax.make_jaxpr(lambda v, a: jblock.apply(v, a))(variables, x))
    assert "custom_vjp_call" in jaxpr
    want = np.asarray(jblock.apply(variables, x))

    sd = convert_variables({"params": {"backbone": variables["params"]},
                            "frozen": {"backbone": variables["frozen"]}})
    block = BottleneckBlock(cin, 32, 8, stride, 1, True, "FrozenBN", has_shortcut,
                            fused_tail=True)
    block.load_state_dict({k.removeprefix("backbone.bottom_up."): v for k, v in sd.items()})
    calls = []
    real = tfr.fused_conv1x1_bn_add_relu
    monkeypatch.setattr(tfr, "fused_conv1x1_bn_add_relu",
                        lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert len(calls) == 1
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL * np.abs(want).max()


CU_SOURCE = Path(tfr.__file__).resolve().parents[1] / "csrc" / "fused_residual.cu"


def _walk(plan, m, n):
    """numpy model of the persistent kernel's walk: block b takes tiles b,
    b + grid, ...; tile t covers rows from (t // tiles_n) * bm and columns
    from (t % tiles_n) * bn, clipped at m and n. Returns the times each
    output element is written and the tiles each block took."""
    tiles_n = -(-n // plan.bn)
    tiles = -(-m // plan.bm) * tiles_n
    cover = np.zeros((m, n), np.int32)
    taken = np.zeros(plan.grid[0], np.int64)
    for b in range(plan.grid[0]):
        for t in range(b, tiles, plan.grid[0]):
            m0, n0 = t // tiles_n * plan.bm, t % tiles_n * plan.bn
            cover[m0:m0 + plan.bm, n0:n0 + plan.bn] += 1
            taken[b] += 1
    return cover, taken


@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("stage,k,n,h,w", R50_TAILS)
def test_plan_takes_the_hopper_kernel_at_r50_tails(stage, k, n, h, w, batch):
    plan = tfr.plan_tail(batch * h * w, k, n, torch.bfloat16, True)
    assert plan.path == "wgmma"
    assert (plan.bm, plan.bn, plan.stages) == tfr.WGMMA_TILE
    assert plan.grid[0] <= tfr.H100_SMS and plan.grid[1] == 1


@pytest.mark.parametrize("m,k,n,dtype,aligned,path", [
    (70, 7, 256, torch.bfloat16, True, "mma"),       # K not a multiple of 8
    (70, 64, 20, torch.bfloat16, True, "mma"),       # N not a multiple of 8
    (70, 12, 13, torch.bfloat16, True, "mma"),
    (134400, 64, 256, torch.bfloat16, False, "mma"),  # an operand off a 16-byte boundary
    (134400, 64, 256, torch.float32, True, "ffma"),
    (63, 8, 32, torch.float32, False, "ffma"),
])
def test_plan_keeps_the_older_kernels(m, k, n, dtype, aligned, path):
    plan = tfr.plan_tail(m, k, n, dtype, aligned)
    assert plan.path == path
    tile = (128, 128) if path == "mma" else (64, 64)
    assert (plan.bm, plan.bn) == tile
    assert plan.grid == (-(-n // tile[1]), -(-m // tile[0])) and plan.rounds == 1


def test_alignment_sees_a_storage_offset():
    buf = torch.zeros(2 * 4 * 6 * 64 + 1, dtype=torch.bfloat16)
    x = buf[1:].view(2, 4, 6, 64).permute(0, 3, 1, 2)
    assert x.is_contiguous(memory_format=torch.channels_last)
    assert tfr.operands_aligned(buf) and not tfr.operands_aligned(x)
    plan = tfr.plan_tail(48, 64, 256, torch.bfloat16, tfr.operands_aligned(x, buf))
    assert plan.path == "mma"


@pytest.mark.parametrize("m,n", [(1, 8), (63, 40), (129, 256), (2090, 2048), (17024, 256),
                                 (300, 520), (4200, 1024), (2100, 2048), (1050, 2048)])
def test_walk_writes_every_output_once(m, n):
    plan = tfr.plan_tail(m, 64, n, torch.bfloat16, True)
    cover, taken = _walk(plan, m, n)
    assert (cover == 1).all()
    assert taken.sum() == plan.tiles and taken.max() == plan.rounds
    assert taken.min() >= plan.rounds - 1  # a block takes a tile every round but the last


@pytest.mark.parametrize("batch", [1, 2, 8])
@pytest.mark.parametrize("stage,k,n,h,w", R50_TAILS)
def test_walk_covers_r50_tails_once(stage, k, n, h, w, batch):
    """At R50's widths the walk's tiles partition the output: every tile
    once, the last row and column of tiles clipped at m and n."""
    m = batch * h * w
    plan = tfr.plan_tail(m, k, n, torch.bfloat16, True)
    tiles_n = -(-n // plan.bn)
    seen = np.zeros(plan.tiles, np.int32)
    for b in range(plan.grid[0]):
        seen[b::plan.grid[0]] += 1
    assert (seen == 1).all()
    rows = [min(plan.bm, m - m0) for m0 in range(0, m, plan.bm)]
    cols = [min(plan.bn, n - n0) for n0 in range(0, n, plan.bn)]
    assert len(rows) * len(cols) == plan.tiles == len(rows) * tiles_n
    assert sum(rows) * sum(cols) == m * n
    assert -(-plan.tiles // plan.grid[0]) == plan.rounds


def test_source_note_states_the_plans():
    """The tiles, grid and rounds the CUDA source's note states for each R50
    tail are what ``plan_tail`` and the walk give."""
    rows = re.findall(r"^//\s+(res\d)\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)\s+(\d+)x(\d+)\s+(\d+)"
                      r"\s+(\d+)\s+(\d+)\s*$", CU_SOURCE.read_text(), re.M)
    stated = {(r[0], int(r[1])): tuple(map(int, r[2:])) for r in rows}
    assert len(stated) == len(rows) == 12
    for stage, k, n, h, w in R50_TAILS:
        for batch in (1, 2, 8):
            m = batch * h * w
            plan = tfr.plan_tail(m, k, n, torch.bfloat16, True)
            rounds = max(len(range(b, plan.tiles, plan.grid[0])) for b in range(plan.grid[0]))
            assert stated[stage, batch] == (m, k, n, plan.bm, plan.bn, plan.tiles, plan.grid[0],
                                            rounds), (stage, batch)
            assert rounds == plan.rounds


def test_timing_tool_tolerance_and_bytes():
    """``chip_smoke``'s bf16 tolerance for the fused tail takes one ulp of
    each value (plus 1e-5 of the largest) and no more; its byte count reads
    x, the weight and the shortcut and writes the output once."""
    want = torch.tensor([1.0, -3.0, 200.0, 0.0])
    ulp = torch.tensor([2.0 ** -7, 2.0 ** -6, 1.0, 0.0])
    assert chip_smoke.within_tolerance((want + ulp).bfloat16(), want)
    assert not chip_smoke.within_tolerance(want + 3 * ulp, want)
    assert chip_smoke.tail_bytes(8400, 256, 1024, 2) == (
        8400 * 256 + 1024 * 256 + 2 * 8400 * 1024) * 2 + 2 * 1024 * 4
