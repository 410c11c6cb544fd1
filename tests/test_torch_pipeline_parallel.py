"""The mesh's "pipe" axis (parallel/pipeline_parallel.py,
parallel/pipeline_mllm.py) against the JAX package's pipeline functions on
the same mesh shapes and against one device, on the CPU.

The port runs as gloo processes (`dryrun.run_world`): one world of 2 and one
of 4, each started once and running every case of its size
(tests/torch_pipe_ranks.py). JAX's functions need an 8-device mesh, so its
references run meanwhile in one subprocess on the virtual 8-device CPU mesh
(`--xla_force_host_platform_device_count=8`, with tests/conftest.py's x64
and matmul settings). Inputs are made here with numpy (and JAX's
`make_example_batch`) and given to both.

Cases: `make_pipe_mesh`'s rank layout against JAX's device layout for (4),
(2 data x 2 pipe) and (2 x 2 x 2); `split_params`/`merge_params`;
`pipeline_forward`, `pipeline_train_grads` (and `pipeline_train_grads_full`
with a head) on tests/test_pipeline_parallel.py's residual MLP at (P, M) =
(2, 4) and (4, 6) against JAX's functions and the sequential stack, within
that test's 1e-5; `mllm_pipeline_loss_and_grads` at
tests/test_pipeline_parallel.py's tiny float32 config (4 decoder layers)
under pipe 4, (data 2 x pipe 2) and (model 2 x pipe 2) against JAX's
function on the same mesh shape and against JAX's one-device `loss_fn`
gradients, loss within LOSS_RTOL 1e-5 and every gradient within GRAD_ATOL
3e-5 (that test's bounds); a tiny einsum-MoE decoder under pipe 2 against
JAX's function; a bf16 model under pipe 2, whose activations and
cotangents cross stages in bf16.
"""

import dataclasses
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from multi_spatialmllm_tpu.models import llm as JL
from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.models import vit as JV
from multi_spatialmllm_tpu.parallel import pipeline_mllm as JPM
from multi_spatialmllm_tpu_torch.dryrun import run_world
from multi_spatialmllm_tpu_torch.models import llm as TL
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models import vit as TV
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_params_to_state_dict,
)
from multi_spatialmllm_tpu_torch.parallel import pipeline_mllm as PM
from multi_spatialmllm_tpu_torch.parallel import pipeline_parallel as PP
from test_torch_mesh_training import random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL, GRAD_ATOL = 1e-5, 3e-5      # tests/test_pipeline_parallel.py's
MLP_ATOL = 1e-5                        # its residual-MLP bound
BF16_LOSS_REL = 1e-2                   # bf16 pipe against one device
N_MICRO, ROWS = 4, 8
MLP_DIM, MLP_LAYERS, MLP_ROWS = 16, 8, 2
# (stages, microbatches) of the residual-MLP cases, the world they run in,
# and whether the full function (with a head) runs too
GENERIC = {(2, 4): (2, True), (4, 6): (4, False)}
# name: (world, make_pipe_mesh kwargs)
MESHES = {"pipe4": (4, dict(n_stages=4)),
          "data2_pipe2": (4, dict(n_stages=2, n_data=2)),
          "data2_model2_pipe2": (8, dict(n_stages=2, n_data=2, n_model=2)),
          "pipe2": (2, dict(n_stages=2))}
# name: (world, mesh, decoder overrides, dtype)
MLLM = {"pipe4": (4, "pipe4", {}, "float32"),
        "data2_pipe2": (4, "data2_pipe2", {}, "float32"),
        "model2_pipe2": (4, dict(n_stages=2, n_model=2), {}, "float32"),
        "moe_pipe2": (2, "pipe2", dict(moe_experts=4, num_layers=2),
                      "float32"),
        "bf16_pipe2": (2, "pipe2", {}, "bfloat16")}


def configs(dtype="float32", **llm):
    """tests/test_pipeline_parallel.py's tiny MLLM (4 decoder layers here),
    as (JAX config, port config)."""
    def make(M, V, L):
        return M.MLLMConfig(
            vit=V.ViTConfig(image_size=56, patch_size=14, hidden_size=32,
                            num_layers=1, num_heads=2, dtype=dtype),
            llm=L.LLMConfig(**dict(dict(
                vocab_size=128, hidden_size=32, num_layers=4, num_heads=4,
                num_kv_heads=2, ffn_size=64, dtype=dtype), **llm)))
    return make(JM, JV, JL), make(TM, TV, TL)


def _mlp_case(stages, n_micro, head, seed):
    rng = np.random.default_rng(seed)
    d = MLP_DIM

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    case = dict(stages=stages,
                layers=[dict(w1=normal(d, 2 * d, scale=0.1),
                             b1=normal(2 * d, scale=0.1),
                             w2=normal(2 * d, d, scale=0.1))
                        for _ in range(MLP_LAYERS)],
                x=normal(n_micro, MLP_ROWS, d), y=normal(n_micro, MLP_ROWS, d))
    if head:
        case["head"] = dict(w=normal(d, d, scale=0.3))
    return case


def _mesh_kw(mesh):
    return MESHES[mesh][1] if isinstance(mesh, str) else mesh


@pytest.fixture(scope="module")
def inputs():
    """Every case's inputs, shared by the port's worlds and JAX's run."""
    generic = {key: _mlp_case(*key, head, 20 + i)
               for i, (key, (_, head)) in enumerate(GENERIC.items())}
    mllm = {}
    for name, (world, mesh, llm, dtype) in MLLM.items():
        jcfg, tcfg = configs(dtype, **llm)
        params = jax.tree_util.tree_map(np.asarray, random_params(jcfg, 3))
        batch = {k: np.asarray(v) for k, v in JM.make_example_batch(
            jcfg, batch=ROWS, n_tiles=1, seq_len=32).items()}
        mllm[name] = dict(world=world, mesh=_mesh_kw(mesh), jcfg=jcfg,
                          tcfg=tcfg, params=params, batch=batch,
                          state={k: v.numpy() for k, v in
                                 jax_params_to_state_dict(params,
                                                          jcfg).items()},
                          n_micro=N_MICRO, record_dtypes=dtype == "bfloat16")
    return generic, mllm


def _world(inputs, n):
    generic, mllm = inputs
    meshes = {name: kw for name, (world, kw) in MESHES.items()
              if world == n}
    gen = {key: c for key, c in generic.items() if GENERIC[key][0] == n}
    port = {name: {k: c[k] for k in ("mesh", "tcfg", "state", "batch",
                                     "n_micro", "record_dtypes")}
            for name, c in mllm.items() if c["world"] == n}
    return run_world(n, "torch_pipe_ranks:pipe_rank", (meshes, gen, port),
                     device="cpu", timeout=600)


# JAX's references, on the virtual 8-device mesh: argv[1] the inputs'
# pickle, argv[2] where the results go
JAX_REFS = r"""
import pickle, sys
import jax
jax.config.update("jax_enable_x64", True)
jax.config.update("jax_default_matmul_precision", "highest")
import jax.numpy as jnp
import numpy as np
from multi_spatialmllm_tpu.models.mllm import MultiFrameMLLM, loss_fn
from multi_spatialmllm_tpu.parallel import pipeline_mllm as PM
from multi_spatialmllm_tpu.parallel import pipeline_parallel as PP

with open(sys.argv[1], "rb") as f:
    generic, mllm, meshes = pickle.load(f)
devices = jax.devices()
tonp = lambda t: jax.tree_util.tree_map(np.asarray, t)

def mlp_layer(p, x):
    return x + jnp.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]

def mse(out, tgt):
    return jnp.mean((out - tgt) ** 2)

def seq_stack(layers, x):
    for p in layers:
        x = mlp_layer(p, x)
    return x

out = {"layouts": {}, "generic": {}, "mllm": {}}
for name, kw in meshes.items():
    n = int(np.prod([v for v in kw.values()]))
    mesh = PP.make_pipe_mesh(devices=devices[:n], **kw)
    out["layouts"][name] = (tuple(mesh.axis_names),
                            np.vectorize(lambda d: d.id)(mesh.devices))
for (stages, n_micro), c in generic.items():
    layers = [{k: jnp.asarray(v) for k, v in lp.items()} for lp in c["layers"]]
    x, y = jnp.asarray(c["x"]), jnp.asarray(c["y"])
    mesh = PP.make_pipe_mesh(stages, devices=devices[:stages])
    stacked = PP.stack_stage_params(layers, stages)
    r = {"fwd": PP.pipeline_forward(stacked, x, mesh, mlp_layer),
         "seq_fwd": jax.vmap(lambda xm: seq_stack(layers, xm))(x)}
    r["loss"], r["grads"] = jax.jit(lambda p, a, b: PP.pipeline_train_grads(
        p, a, b, mesh, mlp_layer, mse))(stacked, x, y)
    def oracle(p):
        per = [jax.tree_util.tree_map(lambda l: l[s, k], p)
               for s in range(stages) for k in range(len(layers) // stages)]
        return jnp.mean(jax.vmap(lambda a, b: mse(seq_stack(per, a), b))(x, y))
    r["seq_loss"], r["seq_grads"] = jax.value_and_grad(oracle)(stacked)
    if "head" in c:
        head = {k: jnp.asarray(v) for k, v in c["head"].items()}
        hl = lambda hp, o, t: mse(o @ hp["w"], t)
        r["full"] = dict(zip(("loss", "grads", "head", "dx"), jax.jit(
            lambda p, h, a, b: PP.pipeline_train_grads_full(
                p, h, a, b, mesh, mlp_layer, hl))(stacked, head, x, y)))
    out["generic"][stages, n_micro] = tonp(r)
singles = {}
for name, c in mllm.items():
    model = MultiFrameMLLM(c["jcfg"])
    batch = {k: jnp.asarray(v) for k, v in c["batch"].items()}
    params = jax.tree_util.tree_map(jnp.asarray, c["params"])
    kw = c["mesh"]
    n = int(np.prod([v for v in kw.values()]))
    mesh = PP.make_pipe_mesh(devices=devices[:n], **kw)
    loss, (pre, stage, head) = jax.jit(
        lambda p, b: PM.mllm_pipeline_loss_and_grads(
            model, p, b, mesh, c["n_micro"]))(params, batch)
    r = {"loss": loss, "grads": PM.merge_params(pre, stage, head, c["jcfg"])}
    if c["jcfg"] not in singles:
        singles[c["jcfg"]] = tonp(jax.jit(jax.value_and_grad(
            lambda p: loss_fn(model, p, batch)))(params))
    r["single_loss"], r["single_grads"] = singles[c["jcfg"]]
    out["mllm"][name] = tonp(r)
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


def _jax_refs(inputs, tmp):
    generic, mllm = inputs
    jmllm = {name: dict(jcfg=c["jcfg"], params=c["params"], batch=c["batch"],
                        mesh=c["mesh"], n_micro=c["n_micro"])
             for name, c in mllm.items() if MLLM[name][3] == "float32"}
    meshes = {name: kw for name, (_, kw) in MESHES.items()}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((generic, jmllm, meshes), f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                            ""))
    proc = subprocess.run([sys.executable, "-c", JAX_REFS,
                           str(tmp / "in.pkl"), str(tmp / "out.pkl")],
                          env=env, capture_output=True, text=True,
                          timeout=600, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    """(world of 2, world of 4, JAX's references), the three started
    together."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(3) as pool:
        worlds = [pool.submit(_world, inputs, n) for n in (2, 4)]
        refs = pool.submit(_jax_refs, inputs,
                           tmp_path_factory.mktemp("jax_pipe"))
        return worlds[0].result(), worlds[1].result(), refs.result()


def _ranks(results, world):
    return results[0] if world == 2 else results[1]


@pytest.mark.parametrize("name", ["pipe4", "data2_pipe2",
                                  "data2_model2_pipe2"])
def test_pipe_mesh_layout_is_jaxs(results, name):
    """`pipe_mesh_layout` lays ranks out as JAX's `make_pipe_mesh` lays
    devices out (rank d*(M*P) + m*P + s is stage s), and `make_pipe_mesh`'s
    DeviceMesh holds that table in the worlds that run it."""
    world, kw = MESHES[name]
    names, ids = results[2]["layouts"][name]
    got_names, got = PP.pipe_mesh_layout(ranks=list(range(8)), **kw)
    assert got_names == names
    np.testing.assert_array_equal(got, ids)
    if world <= 4:
        for rank in _ranks(results, world):
            np.testing.assert_array_equal(rank["meshes"][name], ids)


def test_split_and_merge_params_match_jax(inputs):
    """The port's split of a converted JAX tree is JAX's split, converted
    (layer s*L/P + k at [s, k]), and merge_params inverts split_params."""
    import torch

    c = inputs[1]["pipe4"]
    jcfg, tcfg = c["jcfg"], c["tcfg"]
    state = {k: torch.from_numpy(v) for k, v in c["state"].items()}
    for stages in (1, 2, 4):
        pre, stage, head = PM.split_params(state, tcfg, stages)
        jpre, jstage, jhead = JPM.split_params(c["params"], jcfg, stages)
        per = jcfg.llm.num_layers // stages
        tree = {"vision": jpre["vision"], "projector": jpre["projector"],
                "llm": {"embed": jpre["embed"], **jhead, **{
                    f"layer_{s * per + k}": jax.tree_util.tree_map(
                        lambda v: np.asarray(v)[s, k], jstage)
                    for s in range(stages) for k in range(per)}}}
        want = PM.split_params(jax_params_to_state_dict(tree, jcfg), tcfg,
                               stages)
        for got_part, want_part in zip((pre, stage, head), want):
            assert got_part.keys() == want_part.keys()
            for k in got_part:
                np.testing.assert_array_equal(got_part[k], want_part[k])
        assert {k: v.shape for k, v in stage.items()} == {
            k: (stages, per) + tuple(state[f"llm.layers.0.{k}"].shape)
            for k in stage}
        merged = PM.merge_params(pre, stage, head, tcfg)
        assert list(merged) == list(state)
        for k in state:
            np.testing.assert_array_equal(merged[k], state[k])


@pytest.mark.parametrize("key", list(GENERIC), ids=lambda k: f"P{k[0]}M{k[1]}")
def test_pipeline_forward_matches_jax_and_sequential(results, key):
    ref = results[2]["generic"][key]
    for rank in _ranks(results, GENERIC[key][0]):
        got = rank["generic"][key]["fwd"]
        np.testing.assert_allclose(got, ref["fwd"], atol=MLP_ATOL)
        np.testing.assert_allclose(got, ref["seq_fwd"], atol=MLP_ATOL)


@pytest.mark.parametrize("key", list(GENERIC), ids=lambda k: f"P{k[0]}M{k[1]}")
def test_pipeline_train_grads_match_jax_and_sequential(results, key):
    """The 1F1B loss and every stage gradient (gathered whole) against
    JAX's `pipeline_train_grads` and the unpipelined stack's autodiff."""
    ref = results[2]["generic"][key]
    for rank in _ranks(results, GENERIC[key][0]):
        got = rank["generic"][key]
        for want_loss in (ref["loss"], ref["seq_loss"]):
            np.testing.assert_allclose(got["loss"], want_loss,
                                       rtol=LOSS_RTOL)
        for k, g in got["grads"].items():
            np.testing.assert_allclose(g, ref["grads"][k], atol=MLP_ATOL)
            np.testing.assert_allclose(g, ref["seq_grads"][k], atol=MLP_ATOL)


def test_pipeline_train_grads_full_matches_jax(results):
    """With a trainable head at the last stage: the loss, stage and head
    gradients and d(loss)/d(x) against JAX's `pipeline_train_grads_full`."""
    key = next(k for k, (_, head) in GENERIC.items() if head)
    ref = results[2]["generic"][key]["full"]
    for rank in _ranks(results, GENERIC[key][0]):
        got = rank["generic"][key]["full"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
        for part in ("grads", "head"):
            for k, g in got[part].items():
                np.testing.assert_allclose(g, ref[part][k], atol=MLP_ATOL)
        np.testing.assert_allclose(got["dx"], ref["dx"], atol=MLP_ATOL)


def _held_to(got, loss, grads, jcfg, what):
    np.testing.assert_allclose(got["loss"], float(loss), rtol=LOSS_RTOL,
                               err_msg=what)
    want = jax_params_to_state_dict(grads, jcfg)
    assert got["grads"].keys() == want.keys()
    for k, g in got["grads"].items():
        np.testing.assert_allclose(g, want[k].numpy(), atol=GRAD_ATOL,
                                   err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", ["pipe4", "data2_pipe2", "model2_pipe2",
                                  "moe_pipe2"])
def test_mllm_pipeline_matches_jax(inputs, results, name):
    """The whole MLLM's 1F1B loss and every parameter's gradient (the
    preamble's and head's on every process, the stages' gathered over pipe
    and model) against JAX's `mllm_pipeline_loss_and_grads` on the same
    mesh shape and against JAX's one-device `loss_fn` gradients (the MoE
    routes each row on its own, so microbatching keeps its routing); every
    process reports the same loss."""
    c = inputs[1][name]
    ref = results[2]["mllm"][name]
    ranks = [r["mllm"][name] for r in _ranks(results, c["world"])]
    assert len({r["loss"] for r in ranks}) == 1
    _held_to(ranks[0], ref["loss"], ref["grads"], c["jcfg"], "JAX pipeline")
    _held_to(ranks[0], ref["single_loss"], ref["single_grads"], c["jcfg"],
             "one device")


def test_shard_model_on_a_pipe_mesh_shards_only_the_stage_layers(inputs,
                                                                 results):
    """Under (model 2 x pipe 2) each process holds half the heads and the
    FFN of every decoder layer, and the ViT, projector, embedding, final
    norm and lm_head whole (the JAX pipeline keeps them replicated)."""
    c = inputs[1]["model2_pipe2"]
    full = {k: v.shape for k, v in c["state"].items()}
    for rank in _ranks(results, c["world"]):
        shapes = rank["mllm"]["model2_pipe2"]["shapes"]
        assert shapes.keys() == full.keys()
        for k, shape in shapes.items():
            leaf = k.split(".")[-2]
            halved = (k.startswith("llm.layers.")
                      and leaf in ("wq", "wk", "wv", "wo", "gate", "up",
                                   "down"))
            dim = 1 if leaf in ("wo", "down") else 0
            want = list(full[k])
            if halved:
                want[dim] //= 2
            assert shape == tuple(want), k


def test_bf16_activations_and_cotangents_cross_stages_in_bf16(inputs,
                                                              results):
    """A bf16 model with float32 master weights sends bf16 between stages
    (JAX's buffers are `zeros_like` the bf16 embeddings); its loss is
    finite and within BF16_LOSS_REL of the same model on one device."""
    import torch

    c = inputs[1]["bf16_pipe2"]
    ranks = [r["mllm"]["bf16_pipe2"] for r in _ranks(results, c["world"])]
    for r in ranks:
        assert r["crossed"] == ["torch.bfloat16"], r["crossed"]
    model = TM.MultiFrameMLLM(c["tcfg"], param_dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in c["state"].items()})
    with torch.no_grad():
        want = float(TM.loss_fn(model, {k: torch.tensor(v) for k, v in
                                        c["batch"].items()}))
    assert np.isfinite(ranks[0]["loss"])
    assert abs(ranks[0]["loss"] - want) <= BF16_LOSS_REL * abs(want)
    assert all(np.isfinite(g).all() for g in ranks[0]["grads"].values())
