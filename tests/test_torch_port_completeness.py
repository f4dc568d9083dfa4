"""PyTorch port: every module of the JAX package has its counterpart.

Reads file names only (imports nothing): each .py under landiff_tpu/
must exist at the same relative path under landiff_tpu_torch/. The
port's own extra modules (bridge.py, ckpt/synth.py, ...) are allowed."""

from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _modules(package: str) -> set:
    root = REPO / package
    return {p.relative_to(root).as_posix() for p in root.rglob("*.py")}


def test_every_jax_module_has_a_port():
    jax_modules, port_modules = (_modules("landiff_tpu"),
                                 _modules("landiff_tpu_torch"))
    assert len(jax_modules) > 40
    assert sorted(jax_modules - port_modules) == []
