"""The port's serving tuner (``repro_torch.tuning.serve_tuner``) and the
launch twins of ``examples/tune_serving.py``, ``serve_lm.py`` and
``train_lm.py`` on the CPU: the search space against the JAX package's,
``ServeTuningEnv`` on the example's reduced target (result keys, cache, the
flash blocks restored after a success and after a failure, the HBM limit,
``flash_bq`` moving the counted bytes), and the three entry points at smoke
size with ``--device cpu``."""
import os

import jax
import pytest

from repro_torch.core import TuningFailure
from repro_torch.kernels import flash_xla
from repro_torch.launch import serve_lm, train_lm, tune_serving
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.tuning import serve_tuner
from repro_torch.tuning.serve_tuner import ServeTuningEnv, make_serving_space
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)
from torch_parity import scoped_registries  # noqa: F401  (autouse: registrations end with the test)


def reference_serve_tuner():
    """``repro.tuning.serve_tuner``, imported without the 512-device XLA flag
    that ``repro.launch.dryrun`` sets at import reaching this process."""
    jax.devices()
    prev = os.environ.get("XLA_FLAGS")
    try:
        import repro.tuning.serve_tuner as ref
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return ref


def test_serving_space_is_nonfixed():
    space = make_serving_space()
    assert len(space.type_names) == 3  # remat strategies = "index types"
    cfg = space.default_config("remat_nothing")
    assert "flash_bq" in cfg and "seq_parallel" in cfg


def test_serving_space_equals_the_references():
    ref = reference_serve_tuner().make_serving_space()
    space = make_serving_space()
    assert space.type_names == ref.type_names
    for t in space.type_names:
        assert space.default_config(t) == ref.default_config(t)
    assert [(p.name, p.kind, p.choices, p.default) for p in space.system_params] == \
        [(p.name, p.kind, p.choices, p.default) for p in ref.system_params]
    assert serve_tuner._REMAT == reference_serve_tuner()._REMAT


@pytest.fixture
def env():
    cfg = tune_serving.target(smoke=True)
    return ServeTuningEnv(cfg, tune_serving.register_shape(512, 2), make_host_mesh("cpu"))


def _config(index_type="remat_dots", bq=512, bk=1024, sp=True):
    return {"index_type": index_type, "flash_bq": bq, "flash_bk": bk, "seq_parallel": sp}


def test_env_result_cache_and_blocks(env, monkeypatch):
    calls = []
    trace = serve_tuner._compile_step
    monkeypatch.setattr(serve_tuner, "_compile_step", lambda *a: calls.append(a) or trace(*a))
    prev = flash_xla.get_default_blocks()
    flash_xla.set_default_blocks(64, 128)
    try:
        r = env(_config())
        assert set(r) == {"speed", "recall", "mem_gib"}
        assert r["speed"] > 0 and 0 < r["recall"] < 1 and r["mem_gib"] > 0
        assert flash_xla.get_default_blocks() == (64, 128)  # restored after a success
        assert env(_config()) == r and len(calls) == 1  # a cache hit
        assert len(env.cache) == 1
        env(_config(bq=128))
        assert len(calls) == 2
    finally:
        flash_xla.set_default_blocks(*prev)


def test_env_blocks_are_the_traced_ones_and_move_the_bytes(env, monkeypatch):
    seen = []
    trace = serve_tuner._compile_step

    def spy(*a):
        out = trace(*a)
        seen.append((flash_xla.get_default_blocks(), out["bytes"]))
        return out

    monkeypatch.setattr(serve_tuner, "_compile_step", spy)
    a, b = env(_config(bq=128)), env(_config(bq=1024))
    assert [s[0] for s in seen] == [(128, 1024), (1024, 1024)]
    assert seen[0][1] != seen[1][1] and a["speed"] != b["speed"]


def test_env_failures(env, monkeypatch):
    prev = flash_xla.get_default_blocks()

    def broken(*a):
        raise RuntimeError("no meta kernel")

    monkeypatch.setattr(serve_tuner, "_compile_step", broken)
    with pytest.raises(TuningFailure, match="no meta kernel"):
        env(_config(bq=256))
    assert flash_xla.get_default_blocks() == prev  # restored after a failure
    monkeypatch.undo()
    monkeypatch.setattr(serve_tuner, "HBM_PER_DEV", 1024)
    with pytest.raises(TuningFailure, match="exceeds HBM"):
        env(_config(bq=256))
    assert flash_xla.get_default_blocks() == prev
    assert not env.cache


def test_remat_policies_trade_flops_for_memory(env):
    full = env(_config("remat_nothing"))
    dots = env(_config("remat_dots"))
    assert full["mem_gib"] < dots["mem_gib"]
    assert full["speed"] <= dots["speed"]


def test_tune_serving_launch_smoke(capsys):
    tune_serving.main(["--device", "cpu", "--smoke", "--rounds", "8"])
    out = capsys.readouterr().out
    assert "pareto" in out and "fastest: remat_" in out


def test_serve_lm_launch_smoke(capsys):
    out = serve_lm.main(["--device", "cpu", "--batch", "2", "--prompt-len", "16", "--gen", "4"])
    assert out["tokens"].shape == (2, 5) and out["logits_finite"]
    assert "decode :" in capsys.readouterr().out


def test_train_lm_launch_smoke_resumes(tmp_path, capsys):
    args = ["--device", "cpu", "--steps", "4", "--ckpt-dir", str(tmp_path)]
    first = train_lm.main(args)
    assert len(first["losses"]) == 4 and all(x == x for x in first["losses"])
    again = train_lm.main(["--device", "cpu", "--steps", "6", "--ckpt-dir", str(tmp_path)])
    assert len(again["losses"]) == 2  # resumed from step 4
    assert "resumed from step 4" in capsys.readouterr().out
