"""Which collectives a gloo process group takes on CUDA tensors.

    python3 scripts/torch_gloo_cuda_probe.py

Starts two gloo processes that share card 0 (a new pair for each
collective, since a refused transfer can leave the pair unusable), hands
every collective that the tensor-parallel, FSDP, ring and expert-parallel
paths use a CUDA tensor,
and prints one JSON line: for each collective whether gloo ran it and gave
the right answer ("ok"), ran it and gave a wrong one ("wrong"), or raised
("refused", with the first line of the error); then the seconds a call and
GB/s of the seam's heavy collectives on 32 and 256 MB CUDA tensors (bf16
and f32), with one and with four CPU threads a process. The collective
seam in `parallel/sharding.py` stages the refused ones (`ring_pass`'s sends
and receives) through pinned host memory under a gloo group, and passes
every other one the CUDA tensor as it is.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _probe(only: str) -> dict:
    import torch
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", 0)
    out = {}

    def run(name, fn, want):
        if name != only:
            return
        try:
            got = fn()
            torch.cuda.synchronize()
            ok = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            out[name] = "ok" if ok else "wrong"
        except Exception as exc:          # a probe: report what gloo says
            out[name] = "refused: " + str(exc).splitlines()[0][:160]

    def x(n=4, r=None):
        r = rank if r is None else r
        return (torch.arange(n, dtype=torch.float32) + 10 * r).to(dev)

    full = torch.cat([torch.arange(4.0) + 10 * r for r in range(world)])
    total = sum(torch.arange(4.0 * world) + 10 * r for r in range(world))

    def all_reduce():
        t = x()
        dist.all_reduce(t)
        return [t]
    run("all_reduce", all_reduce,
        [sum(torch.arange(4.0) + 10 * r for r in range(world))])

    def all_gather_into_tensor():
        t = torch.empty(4 * world, device=dev)
        dist.all_gather_into_tensor(t, x())
        return [t]
    run("all_gather_into_tensor", all_gather_into_tensor, [full])

    def all_gather():
        ts = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(ts, x())
        return [torch.cat(ts)]
    run("all_gather", all_gather, [full])

    def reduce_scatter_tensor():
        t = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(t, x(4 * world))
        return [t]
    run("reduce_scatter_tensor", reduce_scatter_tensor,
        [total[4 * rank:4 * rank + 4]])

    def reduce_scatter():
        t = torch.empty(4, device=dev)
        dist.reduce_scatter(t, list(x(4 * world).chunk(world)))
        return [t]
    run("reduce_scatter", reduce_scatter, [total[4 * rank:4 * rank + 4]])

    a2a_want = torch.cat([(torch.arange(4.0 * world) + 10 * r)
                          [4 * rank:4 * rank + 4] for r in range(world)])

    def all_to_all_single():
        t = torch.empty(4 * world, device=dev)
        dist.all_to_all_single(t, x(4 * world))
        return [t]
    run("all_to_all_single", all_to_all_single, [a2a_want])

    def all_to_all():
        outs = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_to_all(outs, list(x(4 * world).chunk(world)))
        return [torch.cat(outs)]
    run("all_to_all", all_to_all, [a2a_want])

    nxt, prv = (rank + 1) % world, (rank - 1) % world

    def send_recv():
        t = torch.empty(4, device=dev)
        if rank % 2 == 0:
            dist.send(x(), nxt)
            dist.recv(t, prv)
        else:
            dist.recv(t, prv)
            dist.send(x(), nxt)
        return [t]
    run("send_recv", send_recv, [torch.arange(4.0) + 10 * prv])

    def batch_isend_irecv():
        t = torch.empty(4, device=dev)
        ops = [dist.P2POp(dist.isend, x(), nxt),
               dist.P2POp(dist.irecv, t, prv)]
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        return [t]
    run("batch_isend_irecv", batch_isend_irecv,
        [torch.arange(4.0) + 10 * prv])

    def broadcast():
        t = x()
        dist.broadcast(t, 0)
        return [t]
    run("broadcast", broadcast, [torch.arange(4.0)])
    return out


OPS = ("all_reduce", "all_gather_into_tensor", "all_gather",
       "reduce_scatter_tensor", "reduce_scatter", "all_to_all_single",
       "all_to_all", "broadcast", "send_recv", "batch_isend_irecv")


def _rates(sizes_mb) -> dict:
    """Seconds a call and GB/s of the collectives the mesh's paths use
    heavily, on CUDA tensors under this gloo group (the seam's routes:
    all-reduce, all-gather and reduce-scatter on the card's tensors, the
    ring's pass through pinned memory)."""
    import time

    import torch
    import torch.distributed as dist

    from multi_spatialmllm_tpu_torch.parallel import sharding as S

    group = dist.group.WORLD
    out = {"threads": torch.get_num_threads()}
    for mb in sizes_mb:
        for dtype in (torch.bfloat16, torch.float32):
            n = mb * 2**20 // torch.finfo(dtype).bits * 8
            t = torch.ones(n, dtype=dtype, device="cuda")
            calls = {
                "all_reduce": lambda: S.all_reduce_(t, group),
                "all_gather": lambda: S.all_gather(t, group, 0),
                "reduce_scatter": lambda: S.reduce_scatter(t, group, 0),
                "ring_pass": lambda: S.ring_pass([t], group)}
            for name, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                dist.barrier()
                t0 = time.perf_counter()
                for _ in range(3):
                    fn()
                torch.cuda.synchronize()
                sec = (time.perf_counter() - t0) / 3
                out[f"{name} {str(dtype)[6:]} {mb} MB"] = {
                    "s": round(sec, 4), "GB/s": round(mb / 1024 / sec, 3)}
            del t
    return out


def main() -> None:
    import subprocess

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    from multi_spatialmllm_tpu_torch.dryrun import run_world

    res = [{}, {}]
    for op in OPS:
        # a world each: a refused transfer can leave the pair unusable
        try:
            got = run_world(2, "torch_gloo_cuda_probe:_probe", (op,),
                            device="cpu", timeout=120)
        except RuntimeError as exc:
            last = [ln for ln in str(exc).splitlines() if ln.strip()][-1]
            got = [{op: "world failed: " + last[:200]}] * 2
        for r in range(2):
            res[r].update(got[r])
    rates = {}
    for threads in ("1", "4"):
        os.environ["OMP_NUM_THREADS"] = threads
        rates[threads] = run_world(2, "torch_gloo_cuda_probe:_rates",
                                   ((32, 256),), device="cpu",
                                   timeout=600)[0]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": smi, "rank0": res[0],
                      "ranks_agree": res[0] == res[1],
                      "rates_by_omp_threads": rates}))


if __name__ == "__main__":
    main()
