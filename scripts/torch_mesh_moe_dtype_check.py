"""How far the bench MoE's gradients on the mesh move from the run
without a group, in float32 and in bf16.

    python3 scripts/torch_mesh_moe_dtype_check.py

On the card: chip_smoke.py phase 24's part (c), the bench MoE (4 experts)
on bench.py's example batch (4 rows of 2,048 tokens, 2 tiles a row; the
phase cuts it) under (1 x 1 x 1 x 2 expert) with the einsum impl and under
(1 x 2 model) with ragged + K8, 3 steps each, once with both towers in
float32 and once
in bf16, in one world of two gloo processes sharing card 0, each against
the same steps in this process without a group. Prints, per part and
dtype, the losses and grad norms of both runs and the parameters whose
first gradient's norm lies farthest from the run without a group. This is
why phase 24 holds (c) in float32: in bf16 a router's gradient follows the
routing's near ties.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402

PARTS = (("ep_einsum", "einsum", dict(n_data=1, n_expert=2)),
         ("tp_ragged", "ragged", dict(n_data=1, n_model=2)))
DTYPES = ("float32", "bfloat16")


def _kernels():
    from multi_spatialmllm_tpu_torch.ops import attention as A
    from multi_spatialmllm_tpu_torch.ops import grouped_matmul as G

    return [A.FLASH_FWD, A.FLASH_BWD_DQ, A.FLASH_BWD_DKV, G.GMM, G.GMM_T,
            G.TGMM]


def runs(mesh: bool) -> dict:
    """Every part in every dtype, on its mesh or without a group."""
    import torch

    from multi_spatialmllm_tpu_torch.models import mllm as M
    from multi_spatialmllm_tpu_torch.parallel import train as T

    torch.backends.cuda.matmul.allow_tf32 = False
    C.MESH_MOE_BATCH = (4, 2, 2048)      # bench.py's example batch
    out = {}
    for dtype in DTYPES:
        C.MESH_MOE_DTYPE = dtype
        for key, impl, kw in PARTS:
            out[f"{key} {dtype}"] = C.mesh_moe(
                torch, M, T, impl, kw if mesh else None, _kernels())
    return out


def rank() -> dict:
    return runs(mesh=True)


def main() -> int:
    import torch

    from multi_spatialmllm_tpu_torch.dryrun import run_world

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    C.build_all(_kernels())
    ref = runs(mesh=False)
    world = run_world(2, "torch_mesh_moe_dtype_check:rank", (),
                      device="cpu", timeout=600)
    same = ("losses", "grad_norms", "first_grads")
    for key, want in ref.items():
        got = world[0][key]
        rel = {n: abs(got["first_grads"][n] - g) / g
               for n, g in want["first_grads"].items() if g > 0}
        worst = sorted(rel, key=rel.get, reverse=True)[:8]
        print(f"{key}: losses {got['losses']} vs {want['losses']}; grad "
              f"norms {got['grad_norms']} vs {want['grad_norms']}; first "
              f"gradients farthest: "
              f"{[(n, f'{rel[n]:.3g}') for n in worst]}; ranks agree "
              f"{all(r[key][k] == got[k] for r in world for k in same)}",
              flush=True)
    print(C.card_name_and_power_limit())
    return 0


if __name__ == "__main__":
    sys.exit(main())
