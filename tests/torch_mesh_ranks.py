"""What each process of the worlds of tests/test_torch_mesh_training.py
and tests/test_torch_tp_serving.py runs, and the serving runs both sides
share (a module of its own, without JAX, so that a world's processes
import only the port)."""

import numpy as np
import torch

from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.parallel import lora as TL
from multi_spatialmllm_tpu_torch.parallel import sharding as TS
from multi_spatialmllm_tpu_torch.parallel import train as PT
from multi_spatialmllm_tpu_torch.parallel.mesh import make_mesh

STEPS = 3
LORA_TARGETS = ("wq", "wk", "wv", "wo")
LR = 1e-3


def _tcfg(steps):
    return dict(learning_rate=LR, warmup_steps=1, total_steps=steps)


def to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu"
            else torch.from_numpy(v) for k, v in batch.items()}


def _port_run(case, mesh):
    """The case's steps on this process's shard: losses, grad norms, and
    (whole, on rank 0) Adam's first moment after step 0 and the final
    parameters."""
    import torch.distributed as dist

    model = TM.MultiFrameMLLM(case["tcfg"], param_dtype=torch.float32)
    model.load_state_dict(case["state"])
    plan = TS.shard_model(model, mesh, fsdp=case["fsdp"])
    opt = PT.AdamW(list(model.named_parameters()),
                   PT.TrainConfig(**_tcfg(STEPS)))
    step = PT.make_train_step(model, opt, accum_steps=case["accum"],
                              mesh=mesh)
    losses, norms, mu0 = [], [], None
    for i, b in enumerate(case["batches"]):
        m = step(to_torch(PT.local_rows(b, case["accum"], mesh)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if i == 0:     # whole tensors (replicated ones are the live ones)
            mu0 = {k: v.clone() for k, v in
                   TS.optimizer_state(opt, plan)["mu"].items()}
    params = TS.model_state(model)
    first = dist.get_rank() == 0
    return dict(losses=losses, norms=norms, mu0=mu0 if first else None,
                params=params if first else None)


def _lora_run(tcfg, state, jlora_np, batches, mesh):
    import torch.distributed as dist

    model = TM.MultiFrameMLLM(tcfg, param_dtype=torch.float32)
    model.load_state_dict(state)
    TS.shard_model(model, mesh)
    tlora = {k: {p: torch.tensor(v) for p, v in ad.items()}
             for k, ad in jlora_np.items()}
    opt = PT.AdamW(TL.lora_named_tensors(tlora),
                   PT.TrainConfig(**_tcfg(len(batches))))
    step = TL.make_lora_train_step(
        model, opt, TL.LoRAConfig(rank=4, targets=LORA_TARGETS), mesh=mesh)
    losses, norms = [], []
    for b in batches:
        m = step(to_torch(PT.local_rows(b, 1, mesh)))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    lora = {k: {p: t.detach().clone() for p, t in ad.items()}
            for k, ad in tlora.items()}
    return dict(losses=losses, norms=norms,
                lora=lora if dist.get_rank() == 0 else None)


def _ring_run(inputs):
    """Every rank's block of the ring's output and of its gradients (the
    loss `sum(out * g)`), at each kv width."""
    import torch.distributed as dist

    from multi_spatialmllm_tpu_torch.ops.ring_attention import (
        make_seq_mesh,
        ring_attention,
    )
    from multi_spatialmllm_tpu_torch.parallel.mesh import seq_axis

    ring = seq_axis(make_seq_mesh())
    rank, n = dist.get_rank(), dist.get_world_size()
    out = {}
    for kvh, arrays in inputs.items():
        blk = arrays[0].shape[2] // n
        q, k, v, g = (torch.tensor(a[:, :, rank * blk:(rank + 1) * blk])
                      .requires_grad_(i < 3) for i, a in enumerate(arrays))
        o = ring_attention(q, k, v, ring)
        (o * g).sum().backward()
        out[kvh] = (o.detach(), q.grad, k.grad, v.grad)
    return out


def _checkpoint_run(case, root, straight):
    """Under (2 data x 2 model, FSDP), the case whose uninterrupted losses
    are `straight`: a fresh model 2 steps, saved whole (rank 0 writes), and
    another resumed from the save, re-sharded, for the last step."""
    import torch.distributed as dist

    mesh = make_mesh(**case["mesh"])

    def fresh():
        model = TM.MultiFrameMLLM(case["tcfg"], param_dtype=torch.float32)
        model.load_state_dict(case["state"])
        plan = TS.shard_model(model, mesh, fsdp=True)
        opt = PT.AdamW(list(model.named_parameters()),
                       PT.TrainConfig(**_tcfg(STEPS)))
        return model, plan, opt, PT.make_train_step(model, opt, mesh=mesh)

    def run(step, batches):
        return [float(step(to_torch(PT.local_rows(b, 1, mesh)))["loss"])
                for b in batches]

    model, plan, opt, step = fresh()
    head = run(step, case["batches"][:2])
    params, opt_state = TS.model_state(model), TS.optimizer_state(opt, plan)
    if dist.get_rank() == 0:
        PT.save_checkpoint_rolling(root, params, opt_state, step=2)
    dist.barrier()
    saved = PT.restore_checkpoint(root)
    model, plan, opt, step = fresh()
    TS.load_full_state(model, saved["params"])
    opt.load_state_dict(TS.shard_optimizer_state(saved["opt_state"], plan))
    tail = run(step, case["batches"][2:])
    return dict(straight=straight, resumed=head + tail, root=root,
                params=params if dist.get_rank() == 0 else None)


def mesh_rank(cases: dict, lora_case, ring_inputs, root) -> dict:
    """One rank of a world: its cases, the ring, and at world 4 the
    checkpoint drill."""
    import torch.distributed as dist

    world = dist.get_world_size()
    out = {name: _port_run(c, make_mesh(**c["mesh"]))
           for name, c in cases.items()}
    if lora_case is not None:
        out["lora"] = _lora_run(mesh=make_mesh(n_data=1, n_model=2),
                                **lora_case)
    out["ring"] = _ring_run(ring_inputs)
    if world == 4:
        out["checkpoint"] = _checkpoint_run(
            cases["data2_model2"], root, out["data2_model2"]["losses"])
    return out




# --- tests/test_torch_tp_serving.py -----------------------------------------

SERVE_BASE = dict(slots=2, page_size=16, num_pages=64, max_prompt_len=128,
                  max_new_tokens=8, chunk=2, length_bucket=64)
# paged options served under TP: every option at once, native and int8 kv
SERVE_OPTIONS = {
    "native": dict(prefix_cache=True, prefill_chunk=16, vision_cache=2,
                   speculate=2),
    "int8": dict(kv_dtype="int8", prefix_cache=True, prefill_chunk=16,
                 vision_cache=2),
}


def serve_model(cfg, state, mesh=None):
    """The tiny model with `state`, put on `mesh` when given."""
    model = TM.MultiFrameMLLM(cfg)
    model.load_state_dict(state)
    model.eval()
    if mesh is not None:
        TS.shard_model(model, mesh)
    return model


def forced_logits(model, ids, tiles, lens, steps=6):
    """Prefill then `steps` teacher-forced decode steps: the logits of the
    last prompt position and of each step, `[B, V]` each."""
    from multi_spatialmllm_tpu_torch.models.generate import (
        decode_logits,
        prefill,
    )

    with torch.no_grad():
        logits, caches = prefill(model, ids, tiles, 64)
        lens = torch.as_tensor(lens).long()
        outs = [logits[torch.arange(len(lens)), lens - 1]]
        for t in range(steps):
            tok = torch.tensor([[7 + t], [11 + t]])
            outs.append(decode_logits(model, tok, lens + t, caches))
    return [o.clone() for o in outs]


def mixed_requests(requests):
    """Base, adapter and sampled rows in one batch."""
    from multi_spatialmllm_tpu_torch.models.serving import SamplingParams

    return [requests[0], (*requests[1], "ad"),
            (*requests[2], SamplingParams(temperature=0.8, seed=7)),
            (*requests[3], "ad", SamplingParams(temperature=0.6, seed=3)),
            requests[4]]


def serve_lora_run(model, adapters, requests):
    """Multi-LoRA plus sampled serving of `mixed_requests`."""
    from multi_spatialmllm_tpu_torch.models.paged_kv import (
        PagedBatcher,
        PagedConfig,
    )

    lcfg = TL.LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv", "wo"))
    b = PagedBatcher(model, PagedConfig(**SERVE_BASE, sampling=True),
                     pad_id=0, eos_id=2, adapters={"ad": adapters},
                     lora_config=lcfg)
    return [np.asarray(t) for t in b.generate_all(mixed_requests(requests))]


def serve_rank(cfg, state, ids, tiles, lens, requests, adapters) -> dict:
    """One process of a (1 data x 2 model) world: forced-decode logits,
    batched greedy tokens, the paged batcher's tokens under each option,
    and multi-LoRA plus sampled rows."""
    from multi_spatialmllm_tpu_torch.models.generate import (
        greedy_generate_batched,
    )
    from multi_spatialmllm_tpu_torch.models.paged_kv import (
        PagedBatcher,
        PagedConfig,
    )

    model = serve_model(cfg, state, make_mesh(n_data=1, n_model=2))
    out = {"forced": forced_logits(model, ids, tiles, lens)}
    with torch.no_grad():
        out["greedy"] = np.asarray(greedy_generate_batched(
            model, ids, tiles, lens, max_new_tokens=8, eos_id=2))
    for name, kw in SERVE_OPTIONS.items():
        b = PagedBatcher(model, PagedConfig(**SERVE_BASE, **kw), pad_id=0,
                         eos_id=2)
        out[name] = [np.asarray(t) for t in b.generate_all(requests)]
        out[name + "_stats"] = dict(b.stats)
    out["lora"] = serve_lora_run(model, adapters, requests)
    return out


# --- several `train` runs in one launched world ------------------------------

# a launcher's worker: joins the group once, then runs `train` for each argv
# of the JSON list in argv[1] (the group outlives each run); process 0 (the
# one that logs and prints) opens each run's stdout and stderr with a
# "== run i" line; a refused run prints its ValueError and the next starts
SEQUENTIAL_TRAIN = """
import json
import sys

import torch.distributed as dist

from multi_spatialmllm_tpu_torch import __main__ as cli
from multi_spatialmllm_tpu_torch.parallel.distributed import (
    initialize_multihost,
)

initialize_multihost(device="cpu")
for i, argv in enumerate(json.loads(sys.argv[1])):
    if dist.get_rank() == 0:
        print(f"== run {i}", flush=True)
        print(f"== run {i}", file=sys.stderr, flush=True)
    try:
        cli.main(argv)
    except ValueError as exc:
        print(f"refused: {exc}", file=sys.stderr, flush=True)
"""


def split_runs(text: str, n: int) -> list[str]:
    """`SEQUENTIAL_TRAIN`'s output cut into its runs' parts."""
    parts = [""] * n
    i = None
    for line in text.splitlines(keepends=True):
        if line.startswith("== run "):
            i = int(line.split()[2])
        elif i is not None:
            parts[i] += line
    return parts
