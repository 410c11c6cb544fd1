"""The port's training path (multi_spatialmllm_tpu_torch: the training
forward, the losses, `parallel/train.make_train_step` and its rolling
checkpoints) against the JAX package on the `tiny` config in float32.

Both sides start from the same Flax-initialised float32 params (carried
across by `models/convert.py`) and take the same numpy batches. The JAX
side runs its CPU paths (XLA attention); the port its plain versions.

Tolerances:
- logits and losses: atol 1e-4 (f32, other reduction orders), as in
  tests/test_torch_models.py;
- a train step's loss and grad norm, and the first step's gradients, to
  1e-4 of each tensor's largest magnitude. With warmup 1 the first update
  has learning rate 0 (optax reads the schedule at count 0), so after it
  Adam's first moment is (1 - b1) times the clipped gradient: that is how
  the gradients are compared;
- parameters after the steps within the sum of the learning rates of the
  steps taken: Adam normalises each element, so an element whose gradient
  is near zero can move by lr on one side and not on the other.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.models import llm as JL
from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.parallel import train as JT
from multi_spatialmllm_tpu.parallel.mesh import make_mesh
from multi_spatialmllm_tpu_torch.models import llm as TL
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_params_to_state_dict,
)
from multi_spatialmllm_tpu_torch.models.data import DataConfig, pack_samples
from multi_spatialmllm_tpu_torch.parallel import train as PT

ATOL = 1e-4
REL = 1e-4
STEPS = 3
SEQ = 64
N_TILES = 2


def jax_tiny_f32():
    cfg = JM.tiny_config()
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype="float32"),
        llm=dataclasses.replace(cfg.llm, dtype="float32"))


def _sample(rng, cfg, n_tiles, length):
    """(ids, labels, tiles) of one conversation at its true length: BOS,
    the tiles' IMG_CONTEXT slots, then text; the text is supervised."""
    ids = rng.integers(10, cfg.llm.vocab_size, size=length).astype(np.int32)
    ids[0] = 1
    n_ctx = n_tiles * cfg.tokens_per_tile
    ids[1:1 + n_ctx] = cfg.img_context_id
    labels = ids.copy()
    labels[:1 + n_ctx] = -100
    tiles = rng.standard_normal(
        (n_tiles, cfg.vit.image_size, cfg.vit.image_size, 3)
    ).astype(np.float32)
    return ids, labels, tiles


def make_batch(cfg, packed: bool, seed: int, rows: int = 2) -> dict:
    """A numpy batch of `rows` rows of SEQ tokens with N_TILES tile slots:
    padded (one conversation a row, right padding and zero tiles), or
    packed (two conversations a row with per-segment positions and a
    trailing pad segment of id 0)."""
    rng = np.random.default_rng(seed)
    if packed:
        enc = []
        for r in range(rows):
            enc += [_sample(rng, cfg, 1, 28 + 3 * r),
                    _sample(rng, cfg, 1, 22 + 2 * r)]
        out = list(pack_samples(enc, DataConfig(max_seq_len=SEQ,
                                                max_tiles=N_TILES), 0))
        return {k: np.stack([o[k] for o in out]) for k in out[0]}
    ids = np.zeros((rows, SEQ), np.int32)
    labels = np.full((rows, SEQ), -100, np.int32)
    tiles = np.zeros((rows, N_TILES, cfg.vit.image_size,
                      cfg.vit.image_size, 3), np.float32)
    for r in range(rows):
        n = 1 + r % N_TILES
        e_ids, e_labels, e_tiles = _sample(rng, cfg, n, 40 + 7 * r)
        ids[r, :len(e_ids)] = e_ids
        labels[r, :len(e_ids)] = e_labels
        tiles[r, :n] = e_tiles
    return {"input_ids": ids, "labels": labels, "tiles": tiles}


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_init():
    cfg = jax_tiny_f32()
    model = JM.MultiFrameMLLM(cfg)
    b = make_batch(cfg, False, 0)
    params = jax.jit(model.init)(jax.random.key(0),
                                 jnp.asarray(b["input_ids"]),
                                 jnp.asarray(b["tiles"]))
    return cfg, model, params


def port_model(cfg, params):
    model = TM.MultiFrameMLLM(TM.with_dtype(TM.tiny_config(), "float32"),
                              param_dtype=torch.float32)
    model.load_state_dict(jax_params_to_state_dict(params, cfg))
    return model


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9, 17)).astype(np.float32) * 3
    labels = rng.integers(0, 17, size=(2, 9)).astype(np.int32)
    labels[0, :4] = -100
    labels[1, 7:] = -100
    nll_j, n_j = JL.cross_entropy_sum(jnp.asarray(logits),
                                      jnp.asarray(labels))
    nll_t, n_t = TL.cross_entropy_sum(torch.from_numpy(logits),
                                      torch.from_numpy(labels))
    assert int(n_t) == int(n_j) == 12
    np.testing.assert_allclose(float(nll_t), float(nll_j), rtol=1e-6)
    np.testing.assert_allclose(
        float(TL.cross_entropy_loss(torch.from_numpy(logits),
                                    torch.from_numpy(labels))),
        float(JL.cross_entropy_loss(jnp.asarray(logits),
                                    jnp.asarray(labels))), rtol=1e-6)


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_training_forward_and_loss_match_jax(jax_init, packed):
    cfg, jmodel, params = jax_init
    batch = make_batch(cfg, packed, 2)
    kw = {"positions": jnp.asarray(batch["positions"]),
          "segment_ids": jnp.asarray(batch["segment_ids"])} if packed else {}
    want = jmodel.apply(params, jnp.asarray(batch["input_ids"]),
                        jnp.asarray(batch["tiles"]), **kw)
    tmodel = port_model(cfg, params)
    tb = to_torch(batch)
    with torch.no_grad():
        got = tmodel(tb["input_ids"], tb["tiles"],
                     positions=tb.get("positions"),
                     segment_ids=tb.get("segment_ids"))
        loss_t = TM.loss_fn(tmodel, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    loss_j = JM.loss_fn(jmodel, params,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(loss_t), float(loss_j), atol=ATOL)


@pytest.mark.parametrize("packed,accum", [(False, 1), (True, 1),
                                          (False, 2), (True, 2)],
                         ids=["padded-accum1", "packed-accum1",
                              "padded-accum2", "packed-accum2"])
def test_train_steps_match_jax(jax_init, packed, accum):
    cfg, jmodel, params = jax_init
    tcfg = PT.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                          total_steps=STEPS)
    tmodel = port_model(cfg, params)
    opt = PT.AdamW(list(tmodel.named_parameters()), tcfg)
    step = PT.make_train_step(tmodel, opt, accum_steps=accum)

    mesh = make_mesh(n_data=1, devices=jax.devices()[:1])
    tx = JT.make_optimizer(JT.TrainConfig(
        learning_rate=1e-3, warmup_steps=1, total_steps=STEPS))
    jstep = JT.make_train_step(jmodel, tx, mesh, accum_steps=accum)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    jopt = tx.init(jparams)

    lr_sum = 0.0
    for i in range(STEPS):
        batch = make_batch(cfg, packed, 10 + i)
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})
        tm = step(to_torch(batch))
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                REL * abs(float(jm[key])), (i, key)
        lr_sum += PT.learning_rate(tcfg, i)
        if i == 0:   # lr 0: the moments hold the first gradients
            mu_j = jax_params_to_state_dict(jopt[1][0].mu, cfg)
            mu_t = opt.state_dict()["mu"]
            for name, m in mu_t.items():
                want = mu_j[name].numpy()
                err = np.abs(m.numpy() - want).max()
                assert err <= REL * np.abs(want).max() + 1e-12, (name, err)
    assert lr_sum > 0
    p_j = jax_params_to_state_dict(jparams, cfg)
    for name, p in tmodel.state_dict().items():
        err = np.abs(p.numpy() - p_j[name].numpy()).max()
        assert err <= lr_sum, (name, err, lr_sum)


def test_schedule_matches_optax():
    import optax

    tcfg = PT.TrainConfig(learning_rate=3e-4, warmup_steps=4,
                          total_steps=20)
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 4, 20)
    for count in range(0, 25):
        np.testing.assert_allclose(PT.learning_rate(tcfg, count),
                                   float(want(count)), rtol=1e-6,
                                   atol=1e-12)


def test_remat_keeps_loss_and_gradients():
    """Whole-layer recompute (`remat` on the ViT and the LLM) changes what
    the backward stores, not what it computes."""
    cfg = TM.with_dtype(TM.tiny_config(), "float32")
    cfg_remat = dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, remat=True),
        llm=dataclasses.replace(cfg.llm, remat=True))
    batch = to_torch(make_batch(jax_tiny_f32(), True, 5))
    grads = []
    for c in (cfg, cfg_remat):
        model = TM.MultiFrameMLLM(c, param_dtype=torch.float32)
        TM.init_random_weights(model, 0)
        loss = TM.loss_fn(model, batch)
        loss.backward()
        grads.append((loss.item(), {n: p.grad for n, p in
                                    model.named_parameters()}))
    (loss_a, g_a), (loss_b, g_b) = grads
    assert loss_a == pytest.approx(loss_b, rel=1e-6)
    for name, g in g_a.items():
        torch.testing.assert_close(g_b[name], g, rtol=1e-5, atol=1e-7)


PORTED_TRAIN_FLAGS = ("--lora-rank", "--eval-jsonl", "--eval-images-root",
                      "--eval-limit", "--eval-max-new-tokens",
                      "--mc-logprob", "--async-save", "--fsdp")


@pytest.mark.parametrize("flags", [
    ["--lora-rank", "4"], ["--moe-experts", "4", "--expert-parallel", "2"],
    ["--model-parallel", "2"],
    ["--seq-parallel", "2"], ["--expert-parallel", "2"],
    ["--data-parallel", "2"], ["--fsdp"], ["--eval-jsonl", "eval.jsonl"],
    ["--eval-images-root", "."], ["--eval-limit", "5"],
    ["--eval-max-new-tokens", "24"], ["--mc-logprob"],
    ["--async-save"]], ids=lambda f: f[0][2:])
def test_train_cli_refuses_unported_flags(flags):
    """Every training option of the JAX CLI is ported: LoRA, train-time
    eval, async saves and `--fsdp` (on one process, a mesh of one) get
    past the checks to the data, absent here; a mesh axis of 2 (data,
    model, seq or expert) raises before any data is read in a process
    launched alone, since its mesh does not fit one process."""
    from multi_spatialmllm_tpu_torch.__main__ import main

    argv = ["train", "--meta", "absent.json", "--device", "cpu", *flags]
    if flags[0] in PORTED_TRAIN_FLAGS:
        with pytest.raises(FileNotFoundError, match="absent.json"):
            main(argv)
        return
    # two processes are asked for and one was launched
    with pytest.raises(ValueError, match="does not match the 1 process"):
        main(argv)


def test_rolling_checkpoints_resume(tmp_path):
    cfg = TM.with_dtype(TM.tiny_config(), "float32")
    model = TM.MultiFrameMLLM(cfg, param_dtype=torch.float32)
    TM.init_random_weights(model, 0)
    opt = PT.AdamW(list(model.named_parameters()), PT.TrainConfig())
    step = PT.make_train_step(model, opt)
    jcfg = jax_tiny_f32()
    root = tmp_path / "ckpt"
    for s in range(1, 4):
        step(to_torch(make_batch(jcfg, True, s)))
        PT.save_checkpoint_rolling(str(root), model, opt, step=s, keep=2)
    assert (root / "LATEST").read_text().strip() == "step_00000003"
    assert sorted(p.name for p in root.iterdir()
                  if p.name.startswith("step_")) == ["step_00000002",
                                                     "step_00000003"]
    assert PT.resolve_checkpoint(str(root)).endswith("step_00000003")
    state = PT.restore_checkpoint(str(root))
    fresh = TM.MultiFrameMLLM(cfg, param_dtype=torch.float32)
    fresh.load_state_dict(state["params"])
    fresh_opt = PT.AdamW(list(fresh.named_parameters()), PT.TrainConfig())
    fresh_opt.load_state_dict(state["opt_state"])
    assert state["step"] == 3 and fresh_opt.count == opt.count == 3
    for (n, a), (_, b) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, b), n
    for a, b in zip(opt.mu + opt.nu, fresh_opt.mu + fresh_opt.nu):
        assert torch.equal(a, b)


def jax_tiny_moe_f32(**kw):
    cfg = JM.tiny_moe_config()
    return dataclasses.replace(
        cfg, vit=dataclasses.replace(cfg.vit, dtype="float32"),
        llm=dataclasses.replace(cfg.llm, dtype="float32", **kw))


def port_tiny_moe_f32(**kw):
    cfg = TM.with_dtype(TM.tiny_moe_config(), "float32")
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, **kw))


MOE_STEP_CASES = {
    # moe config overrides, remat, accumulation microbatches
    "einsum-accum2": (dict(), False, 2),
    "ragged_pallas-accum1": (dict(moe_impl="ragged", moe_kernel="pallas"),
                             False, 1),
    "ragged_pallas-remat-accum2": (dict(moe_impl="ragged",
                                        moe_kernel="pallas"), True, 2),
}


@pytest.mark.parametrize("case", list(MOE_STEP_CASES))
def test_moe_train_steps_match_jax(case):
    """Two steps of `make_train_step` with the load-balance term (weight
    0.01, the per-layer mean, count-weighted over microbatches) on packed
    rows, against JAX `make_train_step` from the same params: losses and
    grad norms, the first step's gradients, and the params after the
    second (first real) update."""
    kw, remat, accum = MOE_STEP_CASES[case]
    jcfg = jax_tiny_moe_f32(remat=remat, **kw)
    tcfg_m = port_tiny_moe_f32(remat=remat, **kw)
    jmodel = JM.MultiFrameMLLM(jcfg)
    b0 = make_batch(jcfg, True, 20)
    params = jax.jit(jmodel.init)(jax.random.key(3),
                                  jnp.asarray(b0["input_ids"]),
                                  jnp.asarray(b0["tiles"]))
    tmodel = TM.MultiFrameMLLM(tcfg_m, param_dtype=torch.float32)
    tmodel.load_state_dict(jax_params_to_state_dict(params, jcfg))
    tcfg = PT.TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=2)
    opt = PT.AdamW(list(tmodel.named_parameters()), tcfg)
    step = PT.make_train_step(tmodel, opt, accum_steps=accum)
    mesh = make_mesh(n_data=1, devices=jax.devices()[:1])
    tx = JT.make_optimizer(JT.TrainConfig(learning_rate=1e-3,
                                          warmup_steps=1, total_steps=2))
    jstep = JT.make_train_step(jmodel, tx, mesh, accum_steps=accum)
    jparams = jax.tree_util.tree_map(jnp.array, params)
    jopt = tx.init(jparams)
    for i in range(2):
        batch = make_batch(jcfg, True, 21 + i)
        jparams, jopt, jm = jstep(jparams, jopt,
                                  {k: jnp.asarray(v) for k, v in
                                   batch.items()})
        tm = step(to_torch(batch))
        for key in ("loss", "grad_norm"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                REL * abs(float(jm[key])), (i, key)
        if i == 0:   # lr 0: the moments hold the first gradients
            mu_j = jax_params_to_state_dict(jopt[1][0].mu, jcfg)
            for name, m in opt.state_dict()["mu"].items():
                want = mu_j[name].numpy()
                err = np.abs(m.numpy() - want).max()
                assert err <= REL * np.abs(want).max() + 1e-12, (name, err)
    lr_sum = PT.learning_rate(tcfg, 0) + PT.learning_rate(tcfg, 1)
    p_j = jax_params_to_state_dict(jparams, jcfg)
    for name, p in tmodel.state_dict().items():
        err = np.abs(p.numpy() - p_j[name].numpy()).max()
        assert err <= lr_sum, (name, err, lr_sum)


@pytest.mark.parametrize("impl", ["einsum", "ragged"])
def test_moe_remat_counts_each_aux_once(impl):
    """Under whole-layer recompute a layer runs twice; its load-balance
    statistic comes back through the layer's outputs, so the loss and the
    gradients are those without remat."""
    kw = dict(moe_impl=impl, moe_kernel="pallas" if impl == "ragged"
              else "xla")
    batch = to_torch(make_batch(jax_tiny_moe_f32(), True, 6))
    runs = []
    for remat in (False, True):
        model = TM.MultiFrameMLLM(port_tiny_moe_f32(remat=remat, **kw),
                                  param_dtype=torch.float32)
        TM.init_random_weights(model, 0)
        opt = PT.AdamW(list(model.named_parameters()), PT.TrainConfig())
        out = PT.make_train_step(model, opt, accum_steps=2)(batch)
        _, auxes = model(batch["input_ids"], batch["tiles"],
                         positions=batch["positions"],
                         segment_ids=batch["segment_ids"], with_aux=True)
        runs.append((float(out["loss"]), float(out["grad_norm"]),
                     [float(a.detach()) for a in auxes]))
    (loss_a, norm_a, aux_a), (loss_b, norm_b, aux_b) = runs
    assert len(aux_a) == 2 and all(a > 0 for a in aux_a)
    assert loss_b == pytest.approx(loss_a, rel=1e-6)
    assert norm_b == pytest.approx(norm_a, rel=1e-5)


@pytest.mark.parametrize("flags", [
    ["--moe-experts", "4"],
    ["--moe-experts", "4", "--moe-impl", "ragged", "--moe-kernel", "pallas"],
    ["--moe-experts", "4", "--moe-group", "256"],
    ["--moe-experts", "4", "--moe-kernel", "pallas"],
    ["--moe-impl", "ragged"], ["--moe-group", "8"], ["--vocab-size", "800"]],
    ids=lambda f: "_".join(x.strip("-") for x in f))
def test_cli_config_rules_match_jax(flags):
    """`train`'s model config follows the JAX CLI's `_mllm_config`: the
    same config, or a SystemExit with the same message."""
    import argparse

    from multi_spatialmllm_tpu import __main__ as jcli
    from multi_spatialmllm_tpu_torch import __main__ as tcli

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default="bench")
    parser.add_argument("--vocab-size", type=int, default=0)
    parser.add_argument("--moe-experts", type=int, default=0)
    parser.add_argument("--moe-group", type=int, default=0)
    parser.add_argument("--moe-impl", default=None)
    parser.add_argument("--moe-kernel", default=None)
    args = parser.parse_args(flags)
    try:
        want = jcli._mllm_config(args)
    except SystemExit as exc:
        with pytest.raises(SystemExit) as got:
            tcli._config(args)
        assert str(got.value) == str(exc)
        return
    got = tcli._config(args)
    tfields = dataclasses.asdict(got.llm)
    jfields = dataclasses.asdict(want.llm)
    assert {k: jfields[k] for k in tfields} == tfields
