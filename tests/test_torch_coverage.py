"""Every module of ``dpf_tpu`` has its port in ``dpf_tpu_torch``.

Each ``.py`` file under ``dpf_tpu/`` has a file at the same relative
path under ``dpf_tpu_torch/``.  The only exceptions are the three Pallas
files of ``ops/``, which are ported as CUDA kernels; each maps to its
kernels' wrapper in an explicit table.
"""

from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

#: the Pallas sources, ported as kernels: dpf_tpu file -> port file
KERNEL_PORTS = {
    "ops/aes_planes.py": "ops/aes_level.py",
    "ops/pallas_level.py": "ops/subtree.py",
    "ops/pallas_sqrt.py": "ops/sqrt_grid.py",
}


def _modules(pkg: str) -> set:
    base = ROOT / pkg
    return {p.relative_to(base).as_posix() for p in base.rglob("*.py")
            if "__pycache__" not in p.parts}


REFERENCE = sorted(_modules("dpf_tpu"))


def test_reference_has_modules_and_the_kernel_table_is_exact():
    assert len(REFERENCE) > 50
    assert set(KERNEL_PORTS) <= set(REFERENCE)


@pytest.mark.parametrize("rel", REFERENCE)
def test_every_dpf_tpu_module_has_a_port_file(rel):
    port = KERNEL_PORTS.get(rel, rel)
    assert (ROOT / "dpf_tpu_torch" / port).is_file(), (
        "dpf_tpu/%s has no port file dpf_tpu_torch/%s" % (rel, port))


def test_only_the_pallas_files_map_elsewhere():
    ported = _modules("dpf_tpu_torch")
    same = {rel for rel in REFERENCE if rel in ported}
    assert set(REFERENCE) - same == set(KERNEL_PORTS)
