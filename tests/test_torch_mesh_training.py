"""Training over the mesh's model, seq and expert axes and FSDP over data
(parallel/sharding.shard_model, parallel/train.make_train_step,
parallel/lora.make_lora_train_step), and ring attention alone
(ops/ring_attention.py), against the JAX package on ONE device over the
global batch, at the tiny config in float32.

Each world (2 processes, then 4) is started once, as gloo processes on the
CPU (`dryrun.run_world`), and runs every case of its size: (1 data x 2
model), (2 data) with FSDP on packed rows in 2 microbatches,
(1 x 1 x 2 seq) unpacked and on packed rows in 2 microbatches (the
blocks gathered for K1's packed path), (1 x 1 x 1 x 2 expert) with the
einsum MoE, the
ragged MoE with K8's plain version under (1 x 2 model) on packed rows,
LoRA under (1 x 2 model), then (2 data x 2 model) with FSDP and (1 x 2
model x 2 seq) at world 4, the first saved after 2 steps and resumed.
Bounds are those of tests/test_torch_data_parallel.py, for the same
reason: a mesh changes only the order of the sums. Losses and grad norms
within REL 1e-4 relative; the first step's gradients (Adam's first moment
after an update at learning rate 0, gathered whole) within REL of each
tensor's largest magnitude; each parameter's change over 3 steps within
UPDATE_REL 2e-2 of JAX's in norm; LoRA losses within STEP_REL 1e-5 and
adapters within ADAPTER_ATOL 1e-5. Measured over the cases: losses and grad
norms within 3.0e-7 relative, first gradients within 2.2e-6 of each tensor's
largest magnitude. The ring alone,
forward and gradients, against JAX's `reference_attention` and its
autodiff (tests/test_ring_attention.py's shapes, kv heads 3 and 1) within
RING_ATOL 2e-5 (JAX's ring test's bound) at n 2 and 4. The checkpoint
restores on one device to the gathered parameters bit for bit, and a run
resumed from it under the mesh takes the uninterrupted run's losses bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.ops.attention import reference_attention
from multi_spatialmllm_tpu.parallel import lora as JLo
from multi_spatialmllm_tpu.parallel import train as JT
from multi_spatialmllm_tpu.parallel.mesh import make_mesh as j_make_mesh
from multi_spatialmllm_tpu_torch.dryrun import run_world
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_lora_to_port,
    jax_params_to_state_dict,
)
from multi_spatialmllm_tpu_torch.parallel import train as PT
from test_torch_data_parallel import (
    ADAPTER_ATOL,
    REL,
    STEP_REL,
    UPDATE_REL,
    _tcfg,
)
from test_torch_training import (
    jax_tiny_f32,
    jax_tiny_moe_f32,
    make_batch,
    port_tiny_moe_f32,
)

RING_ATOL = 2e-5
ROWS = 4
LORA_TARGETS = ("wq", "wk", "wv", "wo")

# name: (world, mesh, moe overrides or None (dense), fsdp, packed, accum)
CASES = {
    "model2": (2, dict(n_data=1, n_model=2), None, False, False, 1),
    "fsdp_data2": (2, dict(n_data=2), None, True, True, 2),
    "seq2": (2, dict(n_data=1, n_seq=2), None, False, False, 1),
    "seq2_packed": (2, dict(n_data=1, n_seq=2), None, False, True, 2),
    "expert2_einsum": (2, dict(n_data=1, n_expert=2), dict(), False, False,
                       1),
    "ragged_model2": (2, dict(n_data=1, n_model=2),
                      dict(moe_impl="ragged", moe_kernel="pallas"), False,
                      True, 1),
    "data2_model2": (4, dict(n_data=2, n_model=2), None, True, False, 1),
    "model2_seq2": (4, dict(n_data=1, n_model=2, n_seq=2), None, False,
                    False, 1),
}
STEPS = 3


def _batch(cfg, packed, seed):
    return {k: v[:ROWS] for k, v in make_batch(cfg, packed, seed,
                                               rows=ROWS).items()}


def random_params(cfg, seed: int) -> dict:
    """A JAX parameter tree of `cfg` with seeded numpy values (the shapes
    from `jax.eval_shape` of the init, so nothing is compiled): norm
    scales near 1, every other leaf normal with std 0.05."""
    b = JM.make_example_batch(cfg, batch=1, n_tiles=1, seq_len=32)
    shapes = jax.eval_shape(JM.MultiFrameMLLM(cfg).init, jax.random.key(0),
                            b["input_ids"], b["tiles"])
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        if getattr(path[-1], "key", None) == "scale":
            return jnp.asarray(1.0 + 0.1 * x)
        return jnp.asarray(0.05 * x)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _case_inputs(names=tuple(CASES)):
    """The cases' inputs; cases of one decoder (dense, or MoE whatever
    its impl: the same tree) share the initial weights, and cases of one
    decoder and row layout the batches, so that one JAX run serves every
    case of a (decoder, impl, rows, accum) key."""
    out, params, batches = {}, {}, {}
    for name in names:
        world, mesh, moe, fsdp, packed, accum = CASES[name]
        # JAX's ragged reference takes lax.ragged_dot (megablox in
        # interpret mode is the same product, slower)
        jmoe = None if moe is None else dict(
            moe, **({"moe_kernel": "xla"} if "moe_kernel" in moe else {}))
        jcfg = jax_tiny_f32() if moe is None else jax_tiny_moe_f32(**jmoe)
        tcfg = (TM.with_dtype(TM.tiny_config(), "float32") if moe is None
                else port_tiny_moe_f32(**moe))
        kind = moe is not None
        if kind not in params:
            params[kind] = random_params(jcfg, 8)
        if (kind, packed) not in batches:
            batches[kind, packed] = [_batch(jcfg, packed, 71 + i)
                                     for i in range(STEPS)]
        out[name] = dict(
            world=world, mesh=mesh, fsdp=fsdp, accum=accum, tcfg=tcfg,
            jmodel=JM.MultiFrameMLLM(jcfg), params=params[kind], jcfg=jcfg,
            state=jax_params_to_state_dict(params[kind], jcfg),
            batches=batches[kind, packed],
            key=(tuple(sorted((moe or {}).items())), kind, packed, accum))
    return out


def _lora_inputs(cases):
    """LoRA over the dense cases' weights."""
    case = cases["model2"]
    params, cfg = case["params"], case["jcfg"]
    lc = JLo.LoRAConfig(rank=4, targets=LORA_TARGETS)
    jlora = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                   JLo.init_lora(params, lc,
                                                 jax.random.key(10)))
    port = dict(tcfg=case["tcfg"], state=case["state"],
                jlora_np={k: {p: t.numpy() for p, t in ad.items()}
                          for k, ad in jax_lora_to_port(jlora).items()},
                batches=case["batches"])
    return case["jmodel"], params, jlora, lc, port


def _ring_inputs():
    out = {}
    for kvh in (3, 1):
        b, h, s, d = 2, 3, 64, 16
        q = jax.random.normal(jax.random.key(0), (b, h, s, d), jnp.float32)
        k = jax.random.normal(jax.random.key(1), (b, kvh, s, d), jnp.float32)
        v = jax.random.normal(jax.random.key(2), (b, kvh, s, d), jnp.float32)
        g = jax.random.normal(jax.random.key(3), (b, h, s, d), jnp.float32)
        out[kvh] = tuple(np.asarray(a) for a in (q, k, v, g))
    return out


# --- fixtures ---------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    cases = _case_inputs()
    return cases, _lora_inputs(cases), _ring_inputs()


def _picklable(case):
    return {k: case[k] for k in ("mesh", "fsdp", "accum", "tcfg", "state",
                                 "batches")}


def _world(inputs, n, tmp):
    cases, lora, ring = inputs
    mine = {name: _picklable(c) for name, c in cases.items()
            if c["world"] == n}
    return run_world(n, "torch_mesh_ranks:mesh_rank",
                     (mine, lora[4] if n == 2 else None, ring,
                      str(tmp / "ckpt")), device="cpu", timeout=600)


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    """The worlds of 2 and of 4 (started together) and, meanwhile, JAX's
    one-device runs, a process each: (world2, world4, {case key: JAX
    result})."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    first = {}
    for name, case in inputs[0].items():
        first.setdefault(case["key"], name)
    with ThreadPoolExecutor(2) as threads, ProcessPoolExecutor(
            len(first) + 1, mp_context=multiprocessing.get_context("spawn")) \
            as procs:
        worlds = [threads.submit(_world, inputs, n,
                                 tmp_path_factory.mktemp(f"world{n}"))
                  for n in (2, 4)]
        settings = {k: getattr(jax.config, k) for k in (
            "jax_enable_x64", "jax_default_matmul_precision")}
        refs = {key: procs.submit(_jax_ref, name, settings)
                for key, name in first.items()}
        refs["lora"] = procs.submit(_jax_lora_ref, settings)
        return (worlds[0].result(), worlds[1].result(),
                {key: f.result() for key, f in refs.items()})


@pytest.fixture(scope="module")
def world2(results):
    return results[0]


@pytest.fixture(scope="module")
def world4(results):
    return results[1]


def _jax_ref(name, settings):
    """JAX's one-device run of case `name`, in a process of its own (the
    XLA compiles of the cases then overlap) with this process's JAX
    `settings` (tests/conftest.py's)."""
    for k, v in settings.items():
        jax.config.update(k, v)
    return _jax_steps(_case_inputs((name,))[name])


def _jax_steps(case):
    mesh = j_make_mesh(n_data=1, devices=jax.devices()[:1])
    tx = JT.make_optimizer(JT.TrainConfig(**_tcfg(STEPS)))
    jstep = JT.make_train_step(case["jmodel"], tx, mesh,
                               accum_steps=case["accum"])
    jparams = jax.tree_util.tree_map(jnp.array, case["params"])
    jopt = tx.init(jparams)
    losses, norms, mu0 = [], [], None
    for i, b in enumerate(case["batches"]):
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in b.items()})
        losses.append(float(jm["loss"]))
        norms.append(float(jm["grad_norm"]))
        if i == 0:
            mu0 = jax_params_to_state_dict(jopt[1][0].mu, case["jcfg"])
    return losses, norms, mu0, jax_params_to_state_dict(jparams,
                                                        case["jcfg"])


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_step_matches_jax_global_batch(inputs, results, name):
    """Every process's losses and grad norms, the first gradients and each
    parameter's change over the steps against JAX's one-device step on
    the global batch."""
    case = inputs[0][name]
    ranks = results[0] if case["world"] == 2 else results[1]
    losses, norms, mu0, p_j = results[2][case["key"]]
    for r in ranks:
        for i in range(STEPS):
            for got, want in ((r[name]["losses"][i], losses[i]),
                              (r[name]["norms"][i], norms[i])):
                assert abs(got - want) <= REL * abs(want), (i, got, want)
    r0 = ranks[0][name]
    assert set(r0["mu0"]) == set(mu0)
    for k, m in r0["mu0"].items():
        want = mu0[k].numpy()
        err = np.abs(m.numpy() - want).max()
        assert err <= REL * np.abs(want).max() + 1e-12, (k, err)
    init = case["state"]
    for k, p in r0["params"].items():
        moved, want = p - init[k], p_j[k] - init[k]
        err = ((moved - want).norm() / want.norm()).item()
        assert err <= UPDATE_REL, (k, err)


def _jax_lora_ref(settings):
    """JAX's one-device LoRA run of the LoRA case, in a process of its own:
    ([(loss, grad norm) a step], the final adapters in the port's
    names)."""
    for k, v in settings.items():
        jax.config.update(k, v)
    jmodel, params, jlora, lc, port = _lora_inputs(_case_inputs(("model2",)))
    tx = JT.make_optimizer(JT.TrainConfig(**_tcfg(STEPS)))
    mesh = j_make_mesh(n_data=1, devices=jax.devices()[:1])
    jstep = JLo.make_lora_train_step(jmodel, tx, mesh, lc)
    jopt = tx.init(jlora)
    metrics = []
    for b in port["batches"]:
        jlora, jopt, jm = jstep(jlora, jopt, params,
                                {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append((float(jm["loss"]), float(jm["grad_norm"])))
    return metrics, jax_lora_to_port(jlora)


def test_lora_under_model_axis_matches_jax(results, world2):
    """`make_lora_train_step` on a (1 x 2 model) base against JAX's on one
    device: the replicated adapters' gradients are summed over "model"."""
    metrics, want = results[2]["lora"]
    for i, (loss, norm) in enumerate(metrics):
        for r in world2:
            for got, w in ((r["lora"]["losses"][i], loss),
                           (r["lora"]["norms"][i], norm)):
                assert abs(got - w) <= STEP_REL * abs(w), (i, got, w)
    for k, ad in world2[0]["lora"]["lora"].items():
        for part in ("a", "b"):
            err = float((ad[part] - want[k][part]).abs().max())
            assert err <= ADAPTER_ATOL, (k, part, err)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kvh", [3, 1])
def test_ring_matches_jax_reference(inputs, world2, world4, n, kvh):
    """The ring's blocks, concatenated, against JAX's causal
    `reference_attention` and its autodiff gradients (dk/dv at kv width:
    the group sum)."""
    q, k, v, g = (jnp.asarray(a) for a in inputs[2][kvh])
    want = [reference_attention(q, k, v, causal=True)]
    want += list(jax.grad(lambda q, k, v: jnp.sum(
        reference_attention(q, k, v, causal=True) * g),
        argnums=(0, 1, 2))(q, k, v))
    ranks = world2 if n == 2 else world4
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got = torch.cat([r["ring"][kvh][i] for r in ranks], dim=2)
        np.testing.assert_allclose(got.numpy(), np.asarray(want[i]),
                                   atol=RING_ATOL, err_msg=name)


def test_checkpoint_under_mesh_restores_whole_and_resumes(world4):
    """The save under (2 data x 2 model, FSDP) holds the whole tensors: on
    one device it loads into a plain model whose state equals the
    gathered parameters bit for bit; the resumed run's losses equal the
    uninterrupted run's bit for bit, on every process."""
    drill = world4[0]["checkpoint"]
    for r in world4:
        assert r["checkpoint"]["resumed"] == r["checkpoint"]["straight"]
    state = PT.restore_checkpoint(drill["root"])
    model = TM.MultiFrameMLLM(TM.with_dtype(TM.tiny_config(), "float32"),
                              param_dtype=torch.float32)
    model.load_state_dict(state["params"])
    for k, v in model.state_dict().items():
        assert torch.equal(v, drill["params"][k]), k
    assert state["step"] == 2 and state["opt_state"]["count"] == 2
    assert set(state["opt_state"]["mu"]) == set(state["params"])
    for k, v in state["opt_state"]["mu"].items():
        assert v.shape == state["params"][k].shape, k
