"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_has_modules():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = sorted({r for r in _imported_roots(path) if r in ("jax", "jaxlib", "repro")})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# the modules of the port's tuning stack, with a name each must define
TUNING_STACK = {
    "repro_torch.core.baselines": "ALL_BASELINES",
    "repro_torch.vdms.draws": "BuildDraws",
    "repro_torch.vdms.registry": "register_family",
    "repro_torch.vdms.engine": "LiveVDMS",
    "repro_torch.vdms.workload": "replay_trace",
    "repro_torch.vdms.tuning_env": "VDMSTuningEnv",
    "repro_torch.bench.bench_streaming": "check_invariants",
    "repro_torch.bench.common": "run_method",
    "repro_torch.bench.bench_autoconfig": "run",
    "repro_torch.bench.bench_efficiency": "run",
    "repro_torch.bench.bench_ablation": "run",
    "repro_torch.bench.bench_preference": "run",
    "repro_torch.bench.bench_costaware": "run",
    "repro_torch.bench.bench_overhead": "run_ask_overhead",
    "repro_torch.bench.run": "main",
    "repro_torch.vdms.faults": "FaultInjector",
    "repro_torch.ft.monitor": "StragglerMonitor",
    "repro_torch.serving.metrics": "serving_ledger",
    "repro_torch.serving.slo": "SLOMonitor",
    "repro_torch.serving.controller": "ServingController",
    "repro_torch.bench.bench_serving": "run_schedule",
    "repro_torch.bench.bench_chaos": "oracle_exactness_check",
    "repro_torch.launch.serve_chaos": "main",
    "repro_torch.launch.serve_controlled": "main",
    "repro_torch.distributed.sharding": "segment_placement",
    "repro_torch.vdms.sharded": "ShardedVDMS",
    "repro_torch.bench.bench_sharded": "check_invariants",
    "repro_torch.launch.serve_sharded": "main",
    "repro_torch.fleet.descriptor": "DescriptorEmbedding",
    "repro_torch.fleet.transfer": "apply_transfer",
    "repro_torch.fleet.fleet": "FleetSession",
    "repro_torch.bench.bench_fleet": "run",
    "repro_torch.models.transformer": "loss_fn",
    "repro_torch.optim.adamw": "apply_updates",
    "repro_torch.optim.compression": "compress_grads",
    "repro_torch.checkpoint.manager": "CheckpointManager",
    "repro_torch.data.pipeline": "TokenPipeline",
    "repro_torch.launch.train": "run",
    "repro_torch.configs.base": "input_specs",
    "repro_torch.kernels.flash_xla": "set_default_blocks",
    "repro_torch.distributed.pipeline": "pipeline_apply",
    "repro_torch.launch.mesh": "make_host_mesh",
    "repro_torch.launch.hlo_analysis": "Roofline",
    "repro_torch.launch.dryrun": "lower_cell",
    "repro_torch.bench.roofline_table": "markdown_table",
    "repro_torch.tuning.serve_tuner": "ServeTuningEnv",
    "repro_torch.launch.tune_serving": "main",
    "repro_torch.launch.serve_lm": "main",
    "repro_torch.launch.train_lm": "main",
    "repro_torch.launch.tune_constrained": "main",
    "repro_torch.launch.tune_streaming": "main",
    "repro_torch.launch.custom_index_family": "main",
}


@pytest.fixture(scope="module")
def imported_alone():
    """Import each tuning-stack module in a fresh interpreter (no test
    module has loaded JAX there) and list the JAX and reference modules
    that came with it."""
    import json
    import os
    import subprocess
    import sys

    script = (
        "import importlib, json, sys\n"
        "out = {}\n"
        f"for name, attr in {TUNING_STACK!r}.items():\n"
        "    mod = importlib.import_module(name)\n"
        "    out[name] = [hasattr(mod, attr), sorted(m for m in sys.modules\n"
        "                 if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))]\n"
        "print(json.dumps(out))\n"
    )
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=120)
    assert res.returncode == 0, res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", sorted(TUNING_STACK))
def test_tuning_stack_module_imports_alone(module, imported_alone):
    has_attr, foreign = imported_alone[module]
    assert has_attr, f"{module} lacks {TUNING_STACK[module]}"
    assert foreign == [], f"importing {module} loaded {foreign}"
