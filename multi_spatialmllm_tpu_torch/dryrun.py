"""Multi-process dry run of the port over the mesh (the analogue of
`__graft_entry__.dryrun_multichip`), and the launcher it and the tests use.

    python -m multi_spatialmllm_tpu_torch.dryrun 8 [--device cpu]

`dryrun_multichip(n)` starts `n` processes in one process group: over
NCCL with a card each (it raises when fewer than `n` cards are present),
or over gloo on the CPU when the caller asks for `device="cpu"`. Rank 0
prints the JAX dry run's lines, in its order and on its meshes: the
(data x model) train step on `tiny_config` (`n_model` 2 when n is even),
tensor-parallel greedy decode, the paged batcher (prefix cache, chunked
prefill, vision cache, speculation) and multi-LoRA plus sampled serving
under the TP-sharded parameters, the (data x model x seq) train step with
ring attention (n divisible by 4), the (data x expert) MoE step (n
divisible by 8), ring attention alone over a seq mesh, then scene-parallel
visibility, frame relations, object visibility and coverage, each asserted
equal to the single-device stage. The three 1F1B lines of the "pipe" axis
say that they wait for their module. A failing child raises. Departures
from the JAX lines: the expert-parallel step takes 8 rows (the port splits
rows over data x expert, JAX over data alone), and the lone ring's head
dim is 32 (the flash kernels take 32, 64 or 128; JAX uses 8).

`run_world(n, "module:function", args)` is the launcher: `n` new Python
processes with the environment `python -m torch.distributed.run` gives
its workers (`RANK`, `LOCAL_RANK`, `WORLD_SIZE`, `MASTER_ADDR`,
`MASTER_PORT`), each joining the group (`initialize_multihost`), calling
`function(*args)` and handing its result back.
"""

from __future__ import annotations

import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_world(n: int, target: str, args: tuple = (), device="cuda",
              timeout: float = 600.0) -> list:
    """Run `target` ("module:function") in `n` processes of one process
    group (NCCL when `device` is CUDA, gloo on the CPU; see
    `initialize_multihost`) and return each rank's result, in rank order.
    The children import what this process can import (its `sys.path`)
    and, as under `torch.distributed.run`, take one CPU thread each unless
    `OMP_NUM_THREADS` says otherwise.
    Raises if a child fails or the world outlasts `timeout` seconds; the
    others are killed then, since they would wait in a collective."""
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        base = dict(os.environ, WORLD_SIZE=str(n), MASTER_ADDR="localhost",
                    MASTER_PORT=str(port),
                    PYTHONPATH=os.pathsep.join(p for p in sys.path if p))
        base.setdefault("OMP_NUM_THREADS", "1")
        procs, logs, codes = [], [], []
        try:
            for rank in range(n):
                log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, "-m",
                     "multi_spatialmllm_tpu_torch.dryrun", "--rank-of",
                     target, tmp, str(device)],
                    env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank)),
                    stdout=log, stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            # poll every child each round: a rank that failed while an
            # earlier one still runs ends the world at once
            while None in (codes := [p.poll() for p in procs]):
                if any(c not in (None, 0) for c in codes) \
                        or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            texts = []
            for log in logs:
                log.seek(0)
                texts.append(log.read())
                log.close()
        # a rank that failed by itself before the others were killed
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)] or \
            [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            r = bad[0]
            raise RuntimeError(
                f"rank {r} of {n} ({target}) exited with "
                f"{procs[r].returncode}:\n{texts[r][-4000:]}")
        results = []
        for rank in range(n):
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results


def _rank_main(target: str, tmp: str, device: str) -> None:
    import torch.distributed as dist

    from .parallel.distributed import initialize_multihost

    initialize_multihost(device=device)
    module, name = target.split(":")
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    result = getattr(importlib.import_module(module), name)(*args)
    with open(os.path.join(tmp, f"result{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def _check(ok, what) -> None:
    """A dry-run check that holds under `python -O` too."""
    if not ok:
        raise AssertionError(what)


def _dryrun_rank(n: int, device: str) -> list[str]:
    """One rank of `dryrun_multichip`: the lines rank 0 prints."""
    import torch

    from .core.synthetic import make_scene
    from .models import mllm as M
    from .parallel.mesh import make_mesh
    from .stages.coverage import build_object_coverage
    from .stages.frame_relations import (
        compute_relations_multichip,
        compute_scene_relations,
    )
    from .stages.object_visibility import (
        build_object_visibility,
        object_visibility_multichip,
    )
    from .stages.visibility import (
        compute_scene_visibility,
        compute_visibility_multichip,
    )

    lines = []
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    n_model = 2 if n % 2 == 0 else 1
    n_data = n // n_model
    mesh = make_mesh(n_data=n_data, n_model=n_model)

    cfg = M.tiny_config()
    loss, model = _mesh_step(cfg, mesh, n_data, 32, dev)
    lines.append(f"dryrun_multichip({n}): mesh=({n_data} data x {n_model} "
                 f"model), {backend}/{dev.type}, loss={loss:.4f}")
    lines += _tp_serving_lines(n, model, cfg, n_data, n_model, dev)
    for what in ("FULL-MLLM 1F1B", "combined (data x pipe) MLLM 1F1B step",
                 "combined (data x model x pipe) MLLM 1F1B step"):
        lines.append(f"dryrun_multichip({n}): {what}: waits for the pipe "
                     f"axis (parallel/pipeline_parallel.py, "
                     f"pipeline_mllm.py; ROADMAP.md item 17, step 3)")
    if n % 4 == 0:
        sp_mesh = make_mesh(n_data=2, n_model=n // 4, n_seq=2)
        loss, _ = _mesh_step(cfg, sp_mesh, 2, 64, dev)
        lines.append(f"dryrun_multichip({n}): (data=2 x model={n // 4} x "
                     f"seq=2) train step with ring attention, "
                     f"loss={loss:.4f}")
    if n % 8 == 0:
        ep_mesh = make_mesh(n_data=2, n_model=1, n_expert=4)
        loss, _ = _mesh_step(M.tiny_moe_config(num_experts=4), ep_mesh, 8,
                             32, dev)
        lines.append(f"dryrun_multichip({n}): (data=2 x expert=4) MoE train "
                     f"step (top-2 routed SwiGLU, expert-sharded tables), "
                     f"loss={loss:.4f}")
    lines.append(_lone_ring_line(n, dev))

    dp_mesh = make_mesh(n_data=n)
    scenes = [make_scene(scene_id=f"dry{i:04d}_00", seed=40 + i,
                         n_images=8, n_background=1500, n_objects=2)
              for i in range(n)]
    vis = compute_visibility_multichip(scenes, dp_mesh, dtype=np.float32,
                                       per_device_batch=1, device=device)
    for s in scenes:
        single = compute_scene_visibility(s, np.float32, device=device)
        _check(np.array_equal(vis[s.scene_id], single), s.scene_id)
    lines.append(f"dryrun_multichip({n}): scene-parallel visibility over "
                 f"data axis ok ({len(scenes)} scenes)")

    rel = compute_relations_multichip(scenes, dp_mesh, vis, dtype=np.float32,
                                      per_device_batch=1, device=device)
    for s in scenes:
        single = compute_scene_relations(s, vis=vis[s.scene_id],
                                         dtype=np.float32, device=device)
        for k, v in single.items():
            _check(np.array_equal(rel[s.scene_id][k], v, equal_nan=True),
                   (s.scene_id, k))
    lines.append(f"dryrun_multichip({n}): scene-parallel frame relations "
                 f"over data axis ok ({len(scenes)} scenes, == "
                 f"single-device)")

    ovis = build_object_visibility(scenes, visibility=vis, device=device)
    ovis_mc = object_visibility_multichip(scenes, dp_mesh, vis,
                                          per_device_batch=1, device=device)
    _check(ovis_mc == ovis, "object visibility")
    lines.append(f"dryrun_multichip({n}): scene-parallel object visibility "
                 f"over data axis ok (== single-device)")

    cov_mc = build_object_coverage(scenes, ovis, visibility=vis,
                                   device=device, mesh=dp_mesh)
    cov_single = build_object_coverage(scenes, ovis, visibility=vis,
                                       device=device)
    _check(cov_mc == cov_single, "coverage")
    lines.append(f"dryrun_multichip({n}): scene-parallel coverage intervals "
                 f"over data axis ok (search results == single-device)")
    return lines


def _mesh_step(cfg, mesh, rows: int, seq_len: int, dev):
    """One train step of `cfg` on `mesh` (the model put on it by
    parallel/sharding.shard_model) over a global example batch of `rows`
    rows; (its loss, checked finite, and the model)."""
    import torch

    from .models import mllm as M
    from .parallel.sharding import shard_model
    from .parallel.train import (
        AdamW,
        TrainConfig,
        local_rows,
        make_train_step,
    )

    batch = M.make_example_batch(cfg, batch=rows, n_tiles=1,
                                 seq_len=seq_len, device=dev)
    model = M.MultiFrameMLLM(cfg, device=dev, param_dtype=torch.float32)
    M.init_random_weights(model, 0)
    shard_model(model, mesh)
    opt = AdamW(list(model.named_parameters()), TrainConfig(warmup_steps=1))
    loss = float(make_train_step(model, opt, mesh=mesh)(
        local_rows(batch, 1, mesh))["loss"])
    _check(np.isfinite(loss), f"loss {loss}")
    return loss, model


def _tp_serving_lines(n: int, model, cfg, n_data: int, n_model: int, dev
                      ) -> list[str]:
    """The JAX dry run's serving lines on the TP-sharded model: batched
    greedy decode, the paged batcher with every option, and multi-LoRA
    plus sampled rows."""
    import torch

    from .models import mllm as M
    from .models import prng
    from .models.generate import greedy_generate_batched
    from .models.paged_kv import PagedBatcher, PagedConfig
    from .models.serving import SamplingParams
    from .parallel.lora import LoRAConfig, init_lora
    from .parallel.sharding import model_state

    lines = []
    model.eval()
    sbatch = M.make_example_batch(cfg, batch=2, n_tiles=1, seq_len=32,
                                  device=dev)
    with torch.no_grad():
        toks = greedy_generate_batched(model, sbatch["input_ids"].cpu(),
                                       sbatch["tiles"].cpu(), [24, 32],
                                       max_new_tokens=4, eos_id=2)
    _check(tuple(toks.shape) == (2, 4), f"tokens {tuple(toks.shape)}")
    _check(bool(((toks >= 0) & (toks < cfg.llm.vocab_size)).all()), "ids")
    lines.append(f"dryrun_multichip({n}): tensor-parallel serving decode "
                 f"over the ({n_data} data x {n_model} model) mesh ok")

    rng = np.random.default_rng(9)
    t_img = cfg.tokens_per_tile
    head = rng.integers(10, cfg.llm.vocab_size, size=36).astype(np.int32)
    head[1:1 + t_img] = cfg.img_context_id
    tiles0 = sbatch["tiles"][0].cpu().numpy()
    reqs = [(np.concatenate([head, rng.integers(
        10, cfg.llm.vocab_size, size=6 + 3 * i).astype(np.int32)]), tiles0)
        for i in range(3)]
    batcher = PagedBatcher(
        model, PagedConfig(slots=2, page_size=16, num_pages=48,
                           max_prompt_len=64, max_new_tokens=4, chunk=2,
                           length_bucket=32, prefix_cache=True,
                           prefill_chunk=16, vision_cache=2, speculate=2),
        pad_id=0, eos_id=2)
    outs = batcher.generate_all(reqs)
    _check(len(outs) == 3, "paged outputs")
    _check(batcher.stats["prefill_resumed"] >= 1, batcher.stats)
    lines.append(f"dryrun_multichip({n}): paged serving (prefix cache + "
                 f"chunked prefill + vision cache + speculative) under "
                 f"TP-sharded params ok, stats={batcher.stats}")

    lcfg = LoRAConfig(rank=4, alpha=8.0, targets=("wq", "wv", "wo"))
    full = M.MultiFrameMLLM(cfg, device="meta")
    full.load_state_dict(model_state(model), assign=True)
    adapters = init_lora(full, lcfg, prng.key(11))
    lbatcher = PagedBatcher(
        model, PagedConfig(slots=2, page_size=16, num_pages=48,
                           max_prompt_len=64, max_new_tokens=4, chunk=2,
                           length_bucket=32, sampling=True),
        pad_id=0, eos_id=2, adapters={"ad": adapters}, lora_config=lcfg)
    mixed = [reqs[0], (*reqs[1], "ad"),
             (*reqs[2], SamplingParams(temperature=0.8, seed=7))]
    _check(len(lbatcher.generate_all(mixed)) == 3, "multi-LoRA outputs")
    lines.append(f"dryrun_multichip({n}): paged multi-LoRA + sampled "
                 f"serving under TP-sharded params ok")
    return lines


def _lone_ring_line(n: int, dev) -> str:
    """Ring attention alone over a seq mesh of all `n` processes, its
    blocks gathered and held to plain causal attention."""
    import torch
    import torch.distributed as dist

    from .models import prng
    from .ops.attention import reference_attention
    from .ops.ring_attention import make_seq_mesh, ring_attention
    from .parallel.mesh import seq_axis
    from .parallel.sharding import all_gather

    ring = seq_axis(make_seq_mesh(n))
    q = prng.normal(prng.key(4), (1, 2, 16 * n, 32)).to(dev)
    blk = q[:, :, dist.get_rank() * 16:(dist.get_rank() + 1) * 16]
    with torch.no_grad():
        o = all_gather(ring_attention(blk, blk, blk, ring), ring[0], 2)
    _check(bool(torch.isfinite(o).all()), "ring output")
    err = float((o - reference_attention(q, q, q)).abs().max())
    _check(err < 1e-4, f"ring vs plain attention {err}")
    return f"dryrun_multichip({n}): ring attention over seq axis ok"


def dryrun_multichip(n: int, device="cuda") -> None:
    """Run the dry run over `n` processes on `device` ("cuda":
    a card each over NCCL; "cpu": gloo), see the module docstring, and
    print rank 0's lines. Raises if the card is asked for and fewer than
    `n` are present, or if a child fails."""
    import torch

    if torch.device(device).type == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"dryrun_multichip({n}) on the card needs {n} cards, found "
            f"{torch.cuda.device_count()}; pass device='cpu' (--device cpu) "
            f"for gloo processes on the CPU")
    lines = run_world(n, "multi_spatialmllm_tpu_torch.dryrun:_dryrun_rank",
                      (n, device), device=device)[0]
    for line in lines:
        print(line, flush=True)


if __name__ == "__main__":
    if sys.argv[1] == "--rank-of":
        _rank_main(*sys.argv[2:5])
    else:
        import argparse

        ap = argparse.ArgumentParser(prog="multi_spatialmllm_tpu_torch.dryrun")
        ap.add_argument("n", type=int, help="processes in the group")
        ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
        a = ap.parse_args()
        dryrun_multichip(a.n, a.device)
