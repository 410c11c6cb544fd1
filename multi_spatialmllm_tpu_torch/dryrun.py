"""Multi-process dry run of the port's data axis (the analogue of
`__graft_entry__.dryrun_multichip`, limited to what runs over the mesh's
"data" axis), and the launcher it and the tests use.

    python -m multi_spatialmllm_tpu_torch.dryrun 4 [--device cpu]

`dryrun_multichip(n)` starts `n` processes in one process group: over
NCCL with a card each (it raises when fewer than `n` cards are present),
or over gloo on the CPU when the caller asks for `device="cpu"`. Rank 0
prints the JAX dry run's lines for what runs over the data
axis: a data-parallel train step on `tiny_config` (`n_model=1`), then
scene-parallel visibility, frame relations, object visibility and
coverage, each asserted equal to the single-device stage. A failing child
raises. The JAX dry run's tensor-parallel, serving, 1F1B, ring-attention,
sequence-parallel and expert-parallel lines wait for their modules
(ROADMAP.md, item 17).

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


def run_world(n: int, target: str, args: tuple = (), device="cpu",
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
        procs, logs = [], []
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
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.returncode not in (None, 0)]
                if failed or time.monotonic() > deadline:
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
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
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
    from .parallel.distributed import global_batch_slice
    from .parallel.mesh import make_mesh
    from .parallel.train import AdamW, TrainConfig, make_train_step
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
    mesh = make_mesh(n_data=n, n_model=1)
    dev = torch.device(device)

    cfg = M.tiny_config()
    batch = M.make_example_batch(cfg, batch=n, n_tiles=1, seq_len=32,
                                 device=dev)
    start, size = global_batch_slice(n)
    mine = {k: v[start:start + size] for k, v in batch.items()}
    model = M.MultiFrameMLLM(cfg, device=dev, param_dtype=torch.float32)
    M.init_random_weights(model, 0)
    opt = AdamW(list(model.named_parameters()), TrainConfig(warmup_steps=1))
    loss = float(make_train_step(model, opt, mesh=mesh)(mine)["loss"])
    _check(np.isfinite(loss), f"loss {loss}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    lines.append(f"dryrun_multichip({n}): mesh=({n} data x 1 model), "
                 f"{backend}/{dev.type}, loss={loss:.4f}")

    scenes = [make_scene(scene_id=f"dry{i:04d}_00", seed=40 + i,
                         n_images=8, n_background=1500, n_objects=2)
              for i in range(n)]
    vis = compute_visibility_multichip(scenes, mesh, dtype=np.float32,
                                       per_device_batch=1, device=device)
    for s in scenes:
        single = compute_scene_visibility(s, np.float32, device=device)
        _check(np.array_equal(vis[s.scene_id], single), s.scene_id)
    lines.append(f"dryrun_multichip({n}): scene-parallel visibility over "
                 f"data axis ok ({len(scenes)} scenes)")

    rel = compute_relations_multichip(scenes, mesh, vis, dtype=np.float32,
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
    ovis_mc = object_visibility_multichip(scenes, mesh, vis,
                                          per_device_batch=1, device=device)
    _check(ovis_mc == ovis, "object visibility")
    lines.append(f"dryrun_multichip({n}): scene-parallel object visibility "
                 f"over data axis ok (== single-device)")

    cov_mc = build_object_coverage(scenes, ovis, visibility=vis,
                                   device=device, mesh=mesh)
    cov_single = build_object_coverage(scenes, ovis, visibility=vis,
                                       device=device)
    _check(cov_mc == cov_single, "coverage")
    lines.append(f"dryrun_multichip({n}): scene-parallel coverage intervals "
                 f"over data axis ok (search results == single-device)")
    return lines


def dryrun_multichip(n: int, device="cuda") -> None:
    """Run the data axis's dry run over `n` processes on `device` ("cuda":
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
