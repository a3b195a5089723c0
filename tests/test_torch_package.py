"""Packaging rules of the port: it imports without JAX, Flax, PyYAML or
``cv2`` (the GPU machine has none of them), its CLIs run as modules under
the same rule, PIL is imported by ``data/image_io.py`` alone (and only when
an image is decoded or encoded), its sources name nothing of the JAX
package, the kernel builder refuses clearly without ``nvcc``, and
``chip_smoke.py`` refuses without a CUDA device."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from detectron2_tensorflow_tpu_torch import kernels

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "detectron2_tensorflow_tpu_torch"

BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "yaml", "cv2"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
"""


def _run(code: str, cwd=REPO):
    return subprocess.run([sys.executable, "-c", BLOCKER + code], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_package_and_chip_smoke_import_without_jax_flax_yaml():
    """Every module of the package (the config, data, engine and evaluation
    modules included) and ``chip_smoke.py`` import with JAX, Flax, PyYAML
    and ``cv2`` blocked."""
    code = """
import pkgutil, importlib
import detectron2_tensorflow_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
import chip_smoke
assert "detectron2_tensorflow_tpu" not in sys.modules
assert not any(k.split(".")[0] in ("jax", "flax", "yaml", "cv2") for k in sys.modules)
for m in ("config.yaml_subset", "data.loader", "engine.checkpoint", "engine.evaluator",
          "evaluation.coco_eval", "data.tfrecord_codec", "data.image_io", "data.polygon",
          "data.coco", "data.records", "evaluation.coco_results", "tools.make_synthetic_coco",
          "tools.build_records", "tools.train", "tools.eval", "tools.workflow_check",
          "tools.overfit_check", "tools.workflow_check_panoptic", "data.panoptic",
          "models.sem_seg", "evaluation.panoptic_eval", "evaluation.sem_seg_eval",
          "models.deform_conv", "engine.tta", "models.roi_heads.relation"):
    assert pkg.__name__ + "." + m in sys.modules, m
assert "PIL" not in sys.modules  # imported at the first decode or encode only
print("ok")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_sources_name_nothing_of_jax():
    """No line of the package (Python or CUDA) or of chip_smoke.py names
    JAX, Flax, PyYAML, ``cv2`` or the JAX package."""
    pattern = re.compile(r"import jax|from jax|flax|import yaml\b|from yaml\b|import cv2|from cv2"
                         r"|detectron2_tensorflow_tpu\b")
    sources = [p for p in PKG.rglob("*") if p.suffix in (".py", ".cu") and "_build" not in p.parts]
    assert {"config/yaml_subset.py", "data/loader.py", "engine/evaluator.py",
            "evaluation/rle.py"} <= {str(p.relative_to(PKG)) for p in sources}
    for path in sources + [REPO / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            assert not pattern.search(line), f"{path}: {line}"


@pytest.mark.parametrize("tool", ["make_synthetic_coco", "build_records", "train", "eval",
                                  "workflow_check", "overfit_check", "workflow_check_panoptic"])
def test_clis_run_as_modules_without_jax_flax_yaml(tool):
    """``python -m detectron2_tensorflow_tpu_torch.tools.<tool>`` starts (its
    ``--help``) with JAX, Flax, PyYAML and ``cv2`` blocked."""
    name = f"detectron2_tensorflow_tpu_torch.tools.{tool}"
    code = f"""
import runpy
sys.argv = ["{name}", "--help"]
try:
    runpy.run_module("{name}", run_name="__main__")
except SystemExit as e:
    assert e.code in (0, None), e.code
assert not any(k.split(".")[0] in ("jax", "flax", "yaml", "cv2") for k in sys.modules)
print("ok")
"""
    if tool == "make_synthetic_coco":  # positional arguments only: write a tiny set
        code = "import tempfile\nout = tempfile.mkdtemp()\n" + code.replace(
            '"--help"', 'out, "1", "1"')
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_only_image_io_imports_pil():
    pattern = re.compile(r"^\s*(import PIL|from PIL)")
    users = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py") if "_build" not in p.parts
             for line in p.read_text().splitlines() if pattern.search(line)}
    assert users == {"data/image_io.py"}
    assert not any(pattern.search(line) for line in (REPO / "chip_smoke.py").read_text().splitlines())


def test_kernel_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(kernels, "_libs", {})
    if Path("/usr/local/cuda/bin/nvcc").is_file():
        pytest.skip("this machine has nvcc in /usr/local/cuda")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load("nms_keep")


def test_every_kernel_source_has_a_signature():
    sources = {p.stem for p in (PKG / "csrc").glob("*.cu")}
    assert sources == set(kernels.SIGNATURES) == {"nms_keep", "roi_patch", "fused_residual"}


def test_signatures_name_every_exported_entry_point():
    """Each library binds exactly the ``extern "C"`` functions its source
    exports (``roi_patch`` exports the forward, its ablation variants and
    the backward)."""
    exported = re.compile(r'extern "C" int (\w+)\(')
    for name, entries in kernels.SIGNATURES.items():
        source = (PKG / "csrc" / f"{name}.cu").read_text()
        assert set(exported.findall(source)) == set(entries), name
    assert set(kernels.SIGNATURES["roi_patch"]) == {
        "roi_patch_fwd_launch", "roi_patch_variant_launch", "roi_patch_bwd_launch"}
    assert set(kernels.SIGNATURES["fused_residual"]) == {"fused_conv1x1_bn_add_relu_launch"}


def test_build_model_defaults_to_the_card():
    """``build_model(cfg)`` builds on the card; without one it raises
    instead of building on the CPU."""
    from detectron2_tensorflow_tpu_torch import bench_cfg, build_model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(bench_cfg())


def test_chip_smoke_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    (tmp_path / "chip_smoke.py").write_text((REPO / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120,
                          env={"PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
