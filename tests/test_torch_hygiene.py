"""The port stands alone: it imports neither JAX nor the JAX package (the
machine with the card has no JAX), and its entry points refuse to run
anywhere but the card unless the caller asks for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "linr_pcgc_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "linr_pcgc_tpu")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{os.path.relpath(path, ROOT)}:{node.lineno} imports {bad}"


def test_importing_every_module_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import linr_pcgc_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'linr_pcgc_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = [m for m in set(sys.modules) - before\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'linr_pcgc_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('linr_pcgc_tpu_torch')]))\n"
        "sys.exit(1 if new else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[-1]) >= 20  # every module was imported


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    import numpy as np

    from linr_pcgc_tpu_torch import cli
    from linr_pcgc_tpu_torch.data import PyramidDataset, build_pyramid
    from linr_pcgc_tpu_torch.models import ModelConfig
    from linr_pcgc_tpu_torch.ops.rans import rans_initial_states
    from linr_pcgc_tpu_torch.runtime import TrainConfig, decode_gop, encode_gop, overfit_gop
    from linr_pcgc_tpu_torch.runtime.brick_overfit import assemble_gop_bricks
    from linr_pcgc_tpu_torch.runtime.codec import decode_gop_streams_sb, encode_gop_streams_sb
    from linr_pcgc_tpu_torch.runtime.sb_overfit import assemble_gop_superbricks

    pts = np.zeros((8, 3), np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encode_gop(str(tmp_path / "model.npz"), [], str(tmp_path / "enc"), ModelConfig())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_gop(str(tmp_path / "enc"), None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_pyramid(pts)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PyramidDataset([pts])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rans_initial_states()
    pyr = build_pyramid(pts, device="cpu")
    for assemble in (assemble_gop_superbricks, assemble_gop_bricks):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            assemble([pyr])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        assemble_gop_superbricks([pyr], side=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        encode_gop_streams_sb({}, ModelConfig(), [pyr], side=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        decode_gop_streams_sb({}, ModelConfig(), [[b""]], [pts])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        overfit_gop(PyramidDataset([pts], device="cpu"), [0], 1, ModelConfig(), TrainConfig(),
                    str(tmp_path / "out"))
    for flags in (["--encode", "True"], ["--overfit", "True"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main([*flags, "--result_dir", str(tmp_path / "out")])
