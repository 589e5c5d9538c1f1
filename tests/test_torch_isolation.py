"""The port stands alone: it imports neither jax, flax nor the JAX package,
nor PIL, pandas, sklearn, matplotlib, msgpack or cv2 (it depends on numpy,
torch and the standard library only; the card has no sklearn or
matplotlib), and its entry points run on the card unless the CPU is asked
for."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "unet_research_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "unet_research_tpu", "PIL", "pandas", "sklearn",
           "matplotlib", "msgpack", "cv2")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def test_imports_with_jax_blocked():
    names = list(_modules())
    for required in ("unet_research_tpu_torch.train.loop", "unet_research_tpu_torch.train.state",
                     "unet_research_tpu_torch.train.policies",
                     "unet_research_tpu_torch.train.checkpoint",
                     "unet_research_tpu_torch.data.loading", "unet_research_tpu_torch.ops.losses",
                     "unet_research_tpu_torch.data.dataset", "unet_research_tpu_torch.utils.png",
                     "unet_research_tpu_torch.utils.general", "unet_research_tpu_torch.utils.convert",
                     "unet_research_tpu_torch.evaluation", "unet_research_tpu_torch.evaluation.metrics",
                     "unet_research_tpu_torch.evaluation.artifacts", "unet_research_tpu_torch.cli",
                     "unet_research_tpu_torch.cli.common", "unet_research_tpu_torch.cli.training",
                     "unet_research_tpu_torch.cli.dropblock_uncertainty",
                     "unet_research_tpu_torch.cli.rotational_uncertainty",
                     "unet_research_tpu_torch.cli.create_augmentations",
                     "unet_research_tpu_torch.cli.mf_training",
                     "unet_research_tpu_torch.cli.lf_training",
                     "unet_research_tpu_torch.cli.base_model_mf",
                     "unet_research_tpu_torch.data.drive", "unet_research_tpu_torch.data.augment",
                     "unet_research_tpu_torch.utils.gif", "unet_research_tpu_torch.utils.tiff",
                     "unet_research_tpu_torch.evaluation.density",
                     "unet_research_tpu_torch.evaluation.raster",
                     "unet_research_tpu_torch.cli.create_density",
                     "unet_research_tpu_torch.cli.view_tensors",
                     "unet_research_tpu_torch.cli.run_matrix",
                     "unet_research_tpu_torch.parallel", "unet_research_tpu_torch.parallel.mesh",
                     "unet_research_tpu_torch.parallel.launch"):
        assert required in names
    _import_with_blocked(f"""
for name in {list(_modules())!r}:
    importlib.import_module(name)
""")


def _import_with_blocked(imports: str) -> None:
    """Run `imports` in a fresh interpreter where every BLOCKED module is
    unimportable; none of them may have been loaded at its end."""
    code = f"""
import importlib, importlib.util, sys
BLOCKED = {BLOCKED!r}
def blocked(name):
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)
for name in list(sys.modules):
    if blocked(name):
        del sys.modules[name]
class Finder:
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Finder())
{imports}
print("ok", len([m for m in sys.modules if blocked(m)]))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok 0"


SCRIPTS = [ROOT / "chip_smoke.py", *(ROOT / "scripts" / f"{name}_torch.py"
                                     for name in ("epoch_time", "kernel_times", "trace_mc"))]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + SCRIPTS,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports_in_source(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_blocked(n) for n in names), (path, names)


def test_bench_scripts_import_with_jax_blocked():
    """The port's scripts (epoch times, kernel times, the trace) import with
    jax, the JAX package and PIL (and the other blocked libraries)
    unavailable."""
    _import_with_blocked(f"""
for path in {[str(p) for p in SCRIPTS[1:]]!r}:
    name = path.rsplit("/", 1)[1][:-3]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
""")


def test_entry_points_default_to_the_card(tmp_path):
    from unet_research_tpu_torch.data import ArrayDataset, batch_iterator, create_augmentations
    from unet_research_tpu_torch.device import resolve_device
    from unet_research_tpu_torch.models.unet import UNet, canonical_config
    from unet_research_tpu_torch.train import POLICIES, Trainer, TrainerConfig
    from unet_research_tpu_torch.uncertainty.mc_dropblock import MCDropBlockEngine
    from unet_research_tpu_torch.uncertainty.rotational import RotationalEngine

    cfg = canonical_config(filters=4, model_depth=2, group_norm_groups=2)
    cpu_model = UNet(cfg, device="cpu")
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    ds = ArrayDataset(*(np.zeros((1, 8, 8, 1), np.uint8) for _ in range(3)))
    for call in (resolve_device, lambda: UNet(cfg), lambda: MCDropBlockEngine(cpu_model),
                 lambda: RotationalEngine(cpu_model),
                 lambda: Trainer(cpu_model, POLICIES["none"], TrainerConfig()),
                 lambda: next(batch_iterator(ds, 1, False))):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # the generator raises before it reads the DRIVE tree or creates dest
    # (the tree does not exist: a read would raise FileNotFoundError)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_augmentations(str(tmp_path / "drive"), str(tmp_path / "aug"))
    assert not (tmp_path / "aug").exists()


@pytest.mark.parametrize("cli", ["training", "dropblock_uncertainty", "rotational_uncertainty",
                                 "create_augmentations", "mf_training", "lf_training",
                                 "base_model_mf", "create_density"])
def test_clis_default_to_the_card(tmp_path, cli):
    """Without -device cpu a CLI needs the card: on a host without CUDA it
    raises before it reads or writes anything."""
    import importlib

    if torch.cuda.is_available():
        pytest.skip("a card is present: the CLIs run on it")
    main = importlib.import_module(f"unet_research_tpu_torch.cli.{cli}").main
    if cli == "create_augmentations":
        argv = ["-data_root", str(tmp_path / "data"), "-dest", str(tmp_path / "out")]
    elif cli == "create_density":
        argv = ["-results_root", str(tmp_path / "data"), "-save_path", str(tmp_path / "out")]
    else:
        argv = ["-data_path", str(tmp_path / "data"), "-save_path", str(tmp_path / "out")]
        argv += (["-mode", "test"] if cli.endswith("training")
                 else ["-model_path", str(tmp_path / "m.ckpt")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv)
    assert not (tmp_path / "out").exists()
