"""What each process of the worlds of tests/test_torch_pipeline_parallel.py
runs (a module of its own, without JAX, so that a world's processes import
only the port)."""

import torch
import torch.distributed as dist

from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.parallel import pipeline_mllm as PM
from multi_spatialmllm_tpu_torch.parallel import pipeline_parallel as PP
from multi_spatialmllm_tpu_torch.parallel.sharding import shard_model


def mlp_layer(p, x):
    """tests/test_pipeline_parallel.py's residual MLP block."""
    return x + torch.tanh(x @ p["w1"] + p["b1"]) @ p["w2"]


def mse(out, tgt):
    return ((out - tgt) ** 2).mean()


def head_mse(hp, out, tgt):
    return mse(out @ hp["w"], tgt)


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _np(tree):
    return {k: v.detach().numpy() for k, v in tree.items()}


def generic_run(case):
    """`pipeline_forward`, `pipeline_train_grads` and (with a head)
    `pipeline_train_grads_full` of the residual MLP stack on a pipe mesh of
    the whole world; the stage gradients gathered whole."""
    mesh = PP.make_pipe_mesh(case["stages"])
    stacked = PP.stack_stage_params([_t(lp) for lp in case["layers"]],
                                    case["stages"])
    x, y = torch.from_numpy(case["x"]), torch.from_numpy(case["y"])
    out = dict(fwd=PP.pipeline_forward(stacked, x, mesh, mlp_layer).numpy())
    loss, grads = PP.pipeline_train_grads(stacked, x, y, mesh, mlp_layer, mse)
    out.update(loss=float(loss), grads=_np(PP.gather_stage(grads, mesh)))
    if "head" in case:
        loss, sg, hg, dx = PP.pipeline_train_grads_full(
            stacked, _t(case["head"]), x, y, mesh, mlp_layer, head_mse)
        out["full"] = dict(loss=float(loss),
                           grads=_np(PP.gather_stage(sg, mesh)),
                           head=_np(hg), dx=dx.numpy())
    return out


def _model(tcfg, state, mesh):
    model = TM.MultiFrameMLLM(tcfg, param_dtype=torch.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    if PP.MODEL_AXIS in mesh.mesh_dim_names:
        shard_model(model, mesh)
    return model


def mllm_run(case, record_dtypes=False):
    """`mllm_pipeline_loss_and_grads` on the case's mesh -> every process's
    loss, the whole gradient as a state dict (rank 0), the local parameter
    shapes, and with `record_dtypes` the dtypes of what crossed stages."""
    mesh = PP.make_pipe_mesh(**case["mesh"])
    model = _model(case["tcfg"], case["state"], mesh)
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    crossed = []
    batched = dist.batch_isend_irecv
    if record_dtypes:
        def spy(ops):
            crossed.extend(str(op.tensor.dtype) for op in ops)
            return batched(ops)
        dist.batch_isend_irecv = spy
    try:
        loss, (pre, stage, head) = PM.mllm_pipeline_loss_and_grads(
            model, batch, mesh, case["n_micro"])
    finally:
        dist.batch_isend_irecv = batched
    stage = PP.gather_stage(stage, mesh, PM.tp_stage_param_specs(stage))
    grads = PM.merge_params(pre, stage, head, case["tcfg"])
    return dict(loss=float(loss), crossed=sorted(set(crossed)),
                grads=_np(grads) if dist.get_rank() == 0 else None,
                shapes={n: tuple(p.shape)
                        for n, p in model.named_parameters()})


def pipe_rank(meshes, generic, mllm):
    """One process of a world: the meshes' rank tables, then the generic
    and MLLM cases of its size."""
    out = {"meshes": {name: PP.make_pipe_mesh(**kw).mesh.tolist()
                      for name, kw in meshes.items()}}
    out["generic"] = {key: generic_run(c) for key, c in generic.items()}
    out["mllm"] = {name: mllm_run(c, c.get("record_dtypes", False))
                   for name, c in mllm.items()}
    return out

