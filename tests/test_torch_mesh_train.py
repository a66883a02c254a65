"""Dense-LM training on a ``("data", "model")`` mesh of spawned ``gloo`` ranks
on the CPU (FSDP over data, Megatron tensor parallelism over model), held
against the JAX package's ``train.run`` on an Auto 2 x 2 mesh.

The reference runs once, in a subprocess with 512 forced host devices
(``XLA_FLAGS`` must be set before JAX is imported). Its meshes are built as
``jax.sharding.Mesh(...)``, whose axes are ``Auto``: on jax 0.9.0
``jax.make_mesh`` gives ``Explicit`` axes, which the reference's
``constrain`` refuses. It hands over its initial weights, its parameter
specs and fallbacks, its losses and (through its checkpoints) its final
weights. One process group of four ranks then runs every case of the port
(``tests/torch_mesh_ranks.py``):

* each collective's forward and backward in f64 against the one-process
  computation, on the 2 x 2 mesh over data, model and both;
* the global norm behind ``grad_clip`` counts a replicated leaf once;
* one loss and every gradient on (2, 2), (1, 4) and (4, 1), with
  ``seq_parallel`` on and off and every remat policy, against one device;
* ``train.run`` for 3 steps on (2, 2) and (1, 4) (the kv heads' fallback),
  with ``seq_parallel`` on and off, ``microbatch`` 2 and ``int8_ef``;
* the elastic resume: 2 x 2 preempted after 2 of 4 steps and resumed on one
  device, and the other way round.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro_torch.configs import get_arch, list_archs, reduce
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import ShardingRules, params_sharding, use_rules
from repro_torch.launch import train
from repro_torch.launch.mesh import virtual_mesh
from repro_torch.models import build_model, named_from_numpy, params_from_numpy
from repro_torch.models.api import meta_params
from torch_parity import one_thread  # noqa: F401  (autouse: one torch and one BLAS thread)

ROOT = Path(__file__).resolve().parents[1]
SPEC_MESHES = (((2, 2), ("data", "model")), ((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")))
# f32 on both sides, the same model summed in other orders (XLA's GSPMD
# against the port's explicit collectives and PyTorch's CPU kernels)
LOSS_RTOL = 1e-5  # the losses, relative
# int8_ef against the reference: a last-bit difference in a gradient can
# move round(g / scale) across a half, a whole quantum of difference, which
# Adam turns into a step of ~lr for that element; the port on one device is
# 7.5e-5 from the reference at step 2 of this run, as the port on the mesh
# is (so the mesh run is also held to the one-device run at LOSS_RTOL)
INT8_RTOL = 1e-4
# and the weights under int8_ef, against the one-device run: an element whose
# quantum flipped is off by up to a few steps of lr; at most 1e-3 of the
# elements may be, every other one within PARAM_TOL
INT8_FLIPS, INT8_ATOL = 1e-3, 3 * 1e-3
# the final weights after 3 AdamW steps at lr 1e-3: Adam divides each
# element's moment by its root-mean-square, so where an element's gradient
# is near zero the order of a sum moves its step by up to ~1e-3 of lr
PARAM_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(atol=2e-6, rtol=2e-4)  # a gradient on a mesh against one device
ONE_DEVICE_RTOL = 1e-6  # a loss on a mesh against one device (the same PyTorch ops)

REFERENCE = textwrap.dedent(
    """
    import ast, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    import jax.experimental
    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    import numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_arch, list_archs, reduce
    from repro.distributed.sharding import ShardingRules, params_sharding
    from repro.launch import train
    from repro.models import build_model
    import torch_mesh_ranks as R

    work, meshes = sys.argv[1], ast.literal_eval(sys.argv[2])
    devices = np.array(jax.devices())

    def mesh(shape, names):  # Auto axes, which the reference's constrain takes
        return Mesh(devices[:int(np.prod(shape))].reshape(shape), names)

    out = dict(specs={}, runs={})
    jcfg = reduce(get_arch("glm4-9b"))
    out["params"] = jax.tree_util.tree_map(np.asarray, build_model(jcfg).init(jax.random.PRNGKey(0)))
    for arch in (a for a in list_archs() if get_arch(a).family == "dense"):
        for reduced in (True, False):
            cfg = reduce(get_arch(arch)) if reduced else get_arch(arch)
            shapes = jax.eval_shape(lambda: build_model(cfg).init(jax.random.PRNGKey(0)))
            for shape, names in meshes:
                rules = ShardingRules(mesh(shape, names))
                leaves = jax.tree_util.tree_flatten_with_path(params_sharding(shapes, rules))[0]
                specs = {tuple(k.key for k in path): tuple(s.spec) for path, s in leaves}
                out["specs"][(arch, reduced, shape)] = (specs, list(rules.fallbacks))
    m22 = mesh((2, 2), ("data", "model"))
    for name, over in R.REFERENCE_RUNS.items():
        res = train.run(train.TrainConfig(**dict(R.TRAIN, **over),
                                          ckpt_dir=os.path.join(work, "ref_" + name)), mesh=m22)
        out["runs"][name] = res["losses"]
    with open(os.path.join(work, "reference.pkl"), "wb") as f:
        pickle.dump(out, f)
    """
)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests")])
    env.pop("XLA_FLAGS", None)
    return env


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The reference's results, then every rank's (one spawned group)."""
    work = tmp_path_factory.mktemp("mesh_train")
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(work), repr(SPEC_MESHES)],
                         capture_output=True, text=True, env=_env(), timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = pickle.loads((work / "reference.pkl").read_bytes())
    tokens = np.random.default_rng(1).integers(0, 512, R.GRAD_TOKENS).astype(np.int32)
    (work / "inputs.pkl").write_bytes(pickle.dumps(dict(params=ref["params"], tokens=tokens)))
    sharding.spawn_ranks(R.mesh_ranks, R.WORLD, backend="gloo", device="cpu", args=(str(work),),
                         join_timeout_s=500)
    ranks = [pickle.loads((work / f"rank{r}.pkl").read_bytes()) for r in range(R.WORLD)]
    one = {}  # the port's one-device runs from the same weights
    for name, over in R.REFERENCE_RUNS.items():
        if name != "whole4":
            with R.reference_init(ref["params"]):
                one[name] = train.run(train.TrainConfig(**dict(R.TRAIN, **over),
                                                        ckpt_dir=str(work / f"one_{name}")),
                                      device="cpu")["losses"]
    return dict(ref=ref, ranks=ranks, work=work, tokens=tokens, one=one)


def _tree(npz, prefix):
    """The leaves of a checkpoint under ``prefix`` as a nested dict (bf16
    never occurs: the reduced model is f32)."""
    tree = {}
    for key in npz.files:
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        *parts, last = key[len(prefix) + 1:].split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[last] = npz[key]
    return tree


def _final_params(directory, step):
    return np.load(Path(directory) / f"step_{step:010d}" / "arrays.npz")


def _rel(a, b):
    return abs(a - b) / abs(b)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------
def _reference_path(name):
    """The reference's leaf for a port parameter name, and whether it is
    stacked over the layers."""
    parts = tuple(name.split("."))
    return (("layers",) + parts[2:], True) if parts[0] == "blocks" else (parts, False)


@pytest.mark.parametrize("shape,names", SPEC_MESHES, ids=["2x2", "16x16", "2x16x16"])
def test_params_sharding_equals_the_references(run, shape, names):
    """Every named parameter of every dense config, reduced and at full
    size (shapes on ``meta``): the port's spec is the reference's for the
    same leaf (a stacked leaf's spec less its replicated layer dim), and the
    fallbacks are the same, once a leaf."""
    archs = [a for a in list_archs() if get_arch(a).family == "dense"]
    assert len(archs) == 5
    for arch in archs:
        for reduced in (True, False):
            cfg = reduce(get_arch(arch)) if reduced else get_arch(arch)
            want, want_fallbacks = run["ref"]["specs"][(arch, reduced, shape)]
            rules = ShardingRules(virtual_mesh(shape, names))
            got = params_sharding(meta_params(cfg), rules)
            seen = set()
            for name, sh in got.items():
                path, stacked = _reference_path(name)
                spec = want[path]
                assert stacked == (spec[:1] == (None,) and len(spec) == len(sh.spec) + 1), name
                assert sh.spec == (spec[1:] if stacked else spec), (arch, reduced, name)
                seen.add(path)
            assert seen == set(want), (arch, reduced)
            assert sorted(rules.fallbacks) == sorted(want_fallbacks), (arch, reduced)


# ---------------------------------------------------------------------------
# the collectives and the clipping norm
# ---------------------------------------------------------------------------
def _group(rank, axes):
    """The ranks of the 2 x 2 mesh that share ``rank``'s other coordinates,
    row-major over ``axes``."""
    d, m = divmod(rank, 2)
    if axes == ("data",):
        return [m, 2 + m]
    if axes == ("model",):
        return [2 * d, 2 * d + 1]
    return [0, 1, 2, 3]


def test_collectives_forward_and_backward_in_f64(run):
    """Each collective over data, model and both, along dims 0 and 1: its
    result and the gradient its backward gives, against the one-process
    computation from every rank's input and upstream gradient (f64, exact
    up to the order of a sum)."""
    for r, got in enumerate(run["ranks"]):
        for axes in R.COLL_AXES:
            group = _group(r, axes)
            i, n = group.index(r), len(group)
            for op in R.COLL_OPS:
                for dim in (0, 1):
                    xs = [R.coll_inputs(q, axes, op, dim)[0] for q in group]
                    gs = [R.coll_inputs(q, axes, op, dim)[1] for q in group]
                    if op == "all_gather":
                        y, dx = np.concatenate(xs, dim), np.split(sum(gs), n, dim)[i]
                    elif op == "reduce_scatter":
                        y, dx = np.split(sum(xs), n, dim)[i], np.concatenate(gs, dim)
                    elif op == "all_reduce":
                        y, dx = sum(xs), gs[i]
                    else:
                        y, dx = xs[i], sum(gs)
                    got_y, got_dx = got["collectives"][(axes, op, dim)]
                    np.testing.assert_allclose(got_y, y, rtol=1e-14, atol=1e-14, err_msg=str((r, axes, op, dim)))
                    np.testing.assert_allclose(got_dx, dx, rtol=1e-14, atol=1e-14, err_msg=str((r, axes, op, dim)))
            top = np.maximum.reduce([R.coll_inputs(q, axes, "all_reduce", 0)[0] for q in group])
            np.testing.assert_array_equal(got["collectives"][(axes, "max")], top)


def test_global_norm_counts_a_replicated_leaf_once(run):
    """A leaf split over (data, model), one replicated everywhere and one
    split over model only: the norm of the whole tree on every rank, where
    the sum over every rank's blocks would count the replicas again."""
    full = R.norm_leaves()
    want = float(np.sqrt(sum(np.sum(a.astype(np.float64) ** 2) for a, _ in full.values())))
    for got in run["ranks"]:
        sharded, local = got["norm"]
        assert _rel(sharded, want) < 1e-6
        assert _rel(local, want) > 1e-3  # this rank's blocks alone are not the norm


# ---------------------------------------------------------------------------
# one step's gradients, and the collectives it counts
# ---------------------------------------------------------------------------
def _one_device(remat, np_params, tokens):
    cfg = reduce(get_arch("glm4-9b"))
    params = params_from_numpy(cfg, np_params).requires_grad_(True)
    loss = build_model(cfg, "cpu", remat=remat).loss(params, {"tokens": torch.from_numpy(tokens)})
    names, leaves = zip(*params.named_parameters())
    return float(loss), dict(zip(names, (g.numpy() for g in torch.autograd.grad(loss, leaves))))


def _virtual_stats(dm, sp, remat, tokens):
    """The same loss and gradients traced on ``meta`` over a virtual mesh:
    what the dry-run counts for one rank."""
    cfg = reduce(get_arch("glm4-9b"))
    mesh = virtual_mesh(dm)
    rules = ShardingRules(mesh, seq_parallel=sp)
    comm = col.comm_for(mesh)
    params = meta_params(cfg)
    sharding.shard_params(params, params_sharding(params, rules))
    params.requires_grad_(True)
    rows = tokens.shape[0] // dm[0]
    batch = {"tokens": torch.empty((rows, tokens.shape[1]), dtype=torch.int32, device="meta")}
    comm.stats.reset()
    with use_rules(rules):
        loss = build_model(cfg, "meta", remat=remat).loss(params, batch)
        torch.autograd.grad(loss, list(params.parameters()))
    return comm.stats.snapshot()


@pytest.mark.parametrize("case", R.GRAD_CASES, ids=lambda c: f"{c[0][0]}x{c[0][1]}-sp{int(c[1])}-{c[2]}")
def test_loss_and_gradients_on_a_mesh_equal_one_device(run, case):
    """The loss (equal on every rank) and every gradient, gathered whole,
    against one device on the same weights and batch; each rank's blocks
    have the specs' shapes; each rank's collectives, per kind, are what the
    virtual group counts for the same step on ``meta``."""
    dm, sp, remat = case
    want_loss, want = _one_device(remat, run["ref"]["params"], run["tokens"])
    recs = [rk["grads"][case] for rk in run["ranks"]]
    assert len({r["loss"] for r in recs}) == 1
    assert _rel(recs[0]["loss"], want_loss) < ONE_DEVICE_RTOL
    assert set(recs[0]["grads"]) == set(want)
    for name, g in recs[0]["grads"].items():
        np.testing.assert_allclose(g, want[name], **GRAD_TOL, err_msg=name)
    virtual = _virtual_stats(dm, sp, remat, run["tokens"])
    for r in recs:
        assert r["stats"]["bytes"] == virtual["bytes"] and r["stats"]["counts"] == virtual["counts"]
    assert sum(virtual["counts"].values()) > 0
    if dm == (1, 4):  # the kv heads (2) do not split over 4: wk / wv split by columns
        assert recs[0]["local_shapes"]["blocks.0.attn.wk"] == (128, 16)


# ---------------------------------------------------------------------------
# training against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(R.RUNS))
def test_train_run_on_a_mesh_matches_reference(run, name):
    """``train.run`` for 3 steps on the mesh: every rank's losses equal;
    within ``LOSS_RTOL`` of the reference's ``train.run`` on an Auto 2 x 2
    mesh from the same weights (``INT8_RTOL`` under int8_ef) and of the
    port's one-device run; the final weights that rank 0 gathered and saved
    within ``PARAM_TOL`` of the reference's saved ones (of the one-device
    run's under int8_ef)."""
    dm, sp, over, ref_name = R.RUNS[name]
    losses = [rk["runs"][name]["losses"] for rk in run["ranks"]]
    assert all(ls == losses[0] for ls in losses)
    int8 = over.get("compression") == "int8_ef"
    want, one = run["ref"]["runs"][ref_name], run["one"][ref_name]
    assert len(losses[0]) == len(want) == len(one) == R.TRAIN["steps"]
    for got, ref, alone in zip(losses[0], want, one):
        assert _rel(got, ref) < (INT8_RTOL if int8 else LOSS_RTOL), (losses[0], want)
        assert _rel(got, alone) < LOSS_RTOL, (losses[0], one)
    assert losses[0][-1] < losses[0][0]
    cfg = reduce(get_arch("glm4-9b"))
    mine = _final_params(run["work"] / name, R.TRAIN["steps"])
    held = _final_params(run["work"] / (f"one_{ref_name}" if int8 else f"ref_{ref_name}"),
                         R.TRAIN["steps"])
    theirs = ({k[len("params/"):]: held[k] for k in held.files if k.startswith("params/")} if int8
              else named_from_numpy(cfg, _tree(held, "params")))
    assert {k[len("params/"):] for k in mine.files if k.startswith("params/")} == set(theirs)
    moved = np.abs(mine["params/embed"] - named_from_numpy(cfg, run["ref"]["params"])["embed"]).max()
    assert moved > 1e-4  # the steps moved the weights
    for n, w in theirs.items():
        if not int8:
            np.testing.assert_allclose(mine[f"params/{n}"], w, **PARAM_TOL, err_msg=n)
            continue
        off = ~np.isclose(mine[f"params/{n}"], w, **PARAM_TOL)
        assert off.mean() <= INT8_FLIPS, (n, int(off.sum()))
        np.testing.assert_allclose(mine[f"params/{n}"], w, rtol=0, atol=INT8_ATOL, err_msg=n)
    steps = run["ranks"][0]["runs"][name]["collectives"]
    assert len(steps) == R.TRAIN["steps"] and all(s["bytes"] == steps[0]["bytes"] for s in steps)


def test_elastic_resume_both_ways(run):
    """2 x 2 preempted after 2 of 4 steps, resumed on one device; one device
    preempted after 2, resumed on 2 x 2: both give the reference's
    uninterrupted 4-step losses, and the ranks agree."""
    want = run["ref"]["runs"]["whole4"]
    first, rest = run["ranks"][0]["elastic"]["to_one"]
    solo, resumed = run["ranks"][0]["elastic"]["to_mesh"]
    assert len(first) == len(solo) == R.PREEMPT_AFTER + 1 and len(rest) == len(resumed) == 2
    for losses in (first + rest, solo + resumed):
        for got, ref in zip(losses, want):
            assert _rel(got, ref) < LOSS_RTOL, (losses, want)
    for rk in run["ranks"][1:]:
        assert rk["elastic"]["to_one"][0] == first and rk["elastic"]["to_mesh"][1] == resumed
