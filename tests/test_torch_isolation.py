"""``dpf_tpu_torch`` imports neither JAX (nor flax, optax or orbax) nor the
JAX package.

``dpf_tpu_torch`` itself starts with ``dpf_tpu``, so module names are
matched exactly or by the ``dpf_tpu.`` / ``jax.`` prefix.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "dpf_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax_and_no_dpf_tpu():
    code = ("import sys, dpf_tpu_torch, dpf_tpu_torch.interop, "
            "dpf_tpu_torch.sample, dpf_tpu_torch.utils.bench; "
            "import dpf_tpu_torch.ops.aes_level, dpf_tpu_torch.ops.subtree, "
            "dpf_tpu_torch.ops.sqrt_grid, dpf_tpu_torch.core.sqrtn, "
            "dpf_tpu_torch.utils.profile_batch, dpf_tpu_torch.native, "
            "dpf_tpu_torch.benchmark, dpf_tpu_torch.ops.matmul128, "
            "dpf_tpu_torch.core.keygen, dpf_tpu_torch.core.radix4; "
            "import dpf_tpu_torch.serve, dpf_tpu_torch.serve.bench_load, "
            "dpf_tpu_torch.serve.bench_serve, dpf_tpu_torch.obs, "
            "dpf_tpu_torch.tune, dpf_tpu_torch.utils.profiling; "
            "import dpf_tpu_torch.serve.registry, "
            "dpf_tpu_torch.serve.tenant, dpf_tpu_torch.serve.bench_chaos, "
            "dpf_tpu_torch.serve.bench_multitenant, "
            "dpf_tpu_torch.obs.metrics; "
            "import dpf_tpu_torch.apps, dpf_tpu_torch.apps.batch_pir, "
            "dpf_tpu_torch.apps.sweep, dpf_tpu_torch.apps.codesign, "
            "dpf_tpu_torch.apps.plots, dpf_tpu_torch.serve.bench_pir, "
            "dpf_tpu_torch.utils.pkt_times; "
            "import dpf_tpu_torch.models, dpf_tpu_torch.models.datasets, "
            "dpf_tpu_torch.models.loaders, dpf_tpu_torch.models.rec, "
            "dpf_tpu_torch.models.lm, dpf_tpu_torch.models.checkpoint, "
            "dpf_tpu_torch.models.init, dpf_tpu_torch.core.prf_zoo, "
            "dpf_tpu_torch.core.prf_zoo_hash, "
            "dpf_tpu_torch.core.aes_bitsliced, "
            "dpf_tpu_torch.core.aes_sbox_bp, "
            "dpf_tpu_torch.core.aes_sbox_circuit, "
            "dpf_tpu_torch.ops.prf_zoo; "
            "import dpf_tpu_torch.tune.cache, dpf_tpu_torch.tune.search, "
            "dpf_tpu_torch.tune.fingerprint, dpf_tpu_torch.tune.compcache, "
            "dpf_tpu_torch.tune.kernel_search, "
            "dpf_tpu_torch.tune.serve_tune, dpf_tpu_torch.utils.compat, "
            "dpf_tpu_torch.obs.bench_trace; "
            "import dpf_tpu_torch.parallel, dpf_tpu_torch.parallel.sharded, "
            "dpf_tpu_torch.parallel.multihost, "
            "dpf_tpu_torch.parallel.cluster, "
            "dpf_tpu_torch.parallel.cluster_net, "
            "dpf_tpu_torch.parallel.cluster_worker, "
            "dpf_tpu_torch.tune.mesh_tune, dpf_tpu_torch.utils.hermetic, "
            "dpf_tpu_torch.serve.bench_multichip, "
            "dpf_tpu_torch.serve.bench_multihost; "
            "import dpf_tpu_torch.plan, dpf_tpu_torch.plan.twin, "
            "dpf_tpu_torch.plan.capacity, dpf_tpu_torch.plan.autoscale, "
            "dpf_tpu_torch.plan.bench_plan, "
            "dpf_tpu_torch.serve.bench_bigtable, "
            "dpf_tpu_torch.utils.results, dpf_tpu_torch.utils.scrape; "
            "print('\\n'.join(sorted(sys.modules)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    mods = out.stdout.split()
    assert "dpf_tpu_torch" in mods
    assert [m for m in mods if _forbidden(m)] == []


def test_sources_import_no_jax_and_no_dpf_tpu():
    files = sorted((ROOT / "dpf_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) > 10
    walked = {p.relative_to(ROOT).as_posix() for p in files}
    for part in ("dpf_tpu_torch/serve/engine.py",
                 "dpf_tpu_torch/serve/router.py",
                 "dpf_tpu_torch/obs/tracer.py",
                 "dpf_tpu_torch/tune/search.py",
                 "dpf_tpu_torch/utils/profiling.py",
                 "dpf_tpu_torch/serve/registry.py",
                 "dpf_tpu_torch/serve/tenant.py",
                 "dpf_tpu_torch/serve/bench_chaos.py",
                 "dpf_tpu_torch/serve/bench_multitenant.py",
                 "dpf_tpu_torch/obs/metrics.py",
                 "dpf_tpu_torch/apps/batch_pir.py",
                 "dpf_tpu_torch/apps/sweep.py",
                 "dpf_tpu_torch/apps/codesign.py",
                 "dpf_tpu_torch/apps/plots.py",
                 "dpf_tpu_torch/serve/bench_pir.py",
                 "dpf_tpu_torch/models/datasets.py",
                 "dpf_tpu_torch/models/loaders.py",
                 "dpf_tpu_torch/models/rec.py",
                 "dpf_tpu_torch/models/lm.py",
                 "dpf_tpu_torch/models/checkpoint.py",
                 "dpf_tpu_torch/models/init.py",
                 "dpf_tpu_torch/core/prf_zoo.py",
                 "dpf_tpu_torch/core/prf_zoo_hash.py",
                 "dpf_tpu_torch/core/aes_bitsliced.py",
                 "dpf_tpu_torch/core/aes_sbox_bp.py",
                 "dpf_tpu_torch/core/aes_sbox_circuit.py",
                 "dpf_tpu_torch/ops/prf_zoo.py",
                 "dpf_tpu_torch/tune/cache.py",
                 "dpf_tpu_torch/tune/fingerprint.py",
                 "dpf_tpu_torch/tune/compcache.py",
                 "dpf_tpu_torch/tune/kernel_search.py",
                 "dpf_tpu_torch/tune/serve_tune.py",
                 "dpf_tpu_torch/utils/compat.py",
                 "dpf_tpu_torch/obs/bench_trace.py",
                 "dpf_tpu_torch/parallel/sharded.py",
                 "dpf_tpu_torch/parallel/multihost.py",
                 "dpf_tpu_torch/parallel/cluster.py",
                 "dpf_tpu_torch/parallel/cluster_net.py",
                 "dpf_tpu_torch/parallel/cluster_worker.py",
                 "dpf_tpu_torch/tune/mesh_tune.py",
                 "dpf_tpu_torch/utils/hermetic.py",
                 "dpf_tpu_torch/serve/bench_multichip.py",
                 "dpf_tpu_torch/serve/bench_multihost.py",
                 "dpf_tpu_torch/plan/__init__.py",
                 "dpf_tpu_torch/plan/twin.py",
                 "dpf_tpu_torch/plan/capacity.py",
                 "dpf_tpu_torch/plan/autoscale.py",
                 "dpf_tpu_torch/plan/bench_plan.py",
                 "dpf_tpu_torch/serve/bench_bigtable.py",
                 "dpf_tpu_torch/utils/results.py",
                 "dpf_tpu_torch/utils/scrape.py"):
        assert part in walked, part
    bad = []
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += ["%s: %s" % (path.name, n) for n in names if _forbidden(n)]
    assert bad == []
