"""The port's parameter layout (parallel/sharding.params_shardings) against
the JAX package's (`spec_for_path` and `_add_fsdp`, pure functions of the
path, the shape and the axis sizes, so no JAX mesh is needed), as data.

At the tiny configs the check is element-exact: for every mesh axis, an
array holding each element's shard coordinate under JAX's spec (on the
JAX layout) is carried across by models/convert.py, and must equal the
coordinates the port's spec gives on the port's layout (the ViT's qkv
weight split in each of its three parts). So each process's shard holds
exactly the elements JAX's device holds. `_add_fsdp`'s size floor is
lowered to 2^10 there so that it shards. At the flagship (built on the
meta device; JAX's shapes from `jax.eval_shape`) the specs are compared
through the JAX-dim -> port-dim map the tiny check establishes, with the
real floor of 2^16. Meshes: (4 data x 2 model) and (2 data x 4 expert),
with and without FSDP."""

import functools
import re
import types

import jax
import numpy as np
import pytest
import torch

from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.parallel import sharding as JS
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_params_to_state_dict,
)
from multi_spatialmllm_tpu_torch.parallel import sharding as TS

MESHES = {"4data_2model": {"data": 4, "model": 2},
          "2data_4expert": {"data": 2, "model": 1, "expert": 4}}
TINY_MIN = 2 ** 10


def _stub(sizes):
    """What JAX's functions read of a mesh: its shape and axis names."""
    return types.SimpleNamespace(shape=dict(sizes),
                                 axis_names=tuple(sizes))


def _port_mesh(sizes):
    """What the port's `params_shardings` reads of a mesh (names, sizes)."""
    names = tuple(sizes)
    return types.SimpleNamespace(
        mesh_dim_names=names, size=lambda i: sizes[names[i]])


@functools.cache
def _jax_shapes(cfg):
    """JAX's parameter tree of `cfg` as shapes (`jax.eval_shape`)."""
    b = JM.make_example_batch(cfg, batch=1, n_tiles=1,
                              seq_len=cfg.tokens_per_tile + 8)
    return jax.eval_shape(JM.MultiFrameMLLM(cfg).init, jax.random.key(0),
                          b["input_ids"], b["tiles"])


def jax_specs(cfg, sizes, fsdp, min_size):
    """{JAX path: (shape, spec tuple)}, as JAX's `params_shardings`
    assigns them, with axis sizes instead of a mesh."""
    shapes = _jax_shapes(cfg)
    mesh = _stub(sizes)
    out = {}

    def assign(path, leaf):
        keys = tuple(getattr(k, "key", getattr(k, "name", str(k)))
                     for k in path)
        spec = JS.spec_for_path(keys, len(leaf.shape))
        spec = JS.P(*(a if a in mesh.axis_names else None for a in spec))
        if fsdp:
            spec = JS._add_fsdp(spec, leaf.shape, mesh, min_size)
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        out[keys] = (tuple(leaf.shape), entries)

    jax.tree_util.tree_map_with_path(assign, shapes)
    return out


def _tree(flat: dict) -> dict:
    tree: dict = {}
    for keys, v in flat.items():
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    return tree


def _coord_array(shape, spec, axis, size):
    """Each element's coordinate on `axis` under `spec` (0 where the axis
    shards nothing)."""
    out = np.zeros(shape, np.float32)
    if axis in spec:
        d = spec.index(axis)
        idx = np.arange(shape[d]) // (shape[d] // size)
        out += idx.reshape([-1 if i == d else 1 for i in range(len(shape))])
    return out


def _port_coords(shape, spec, axis, size, blocks):
    """The same coordinates under the port's spec on the port's layout."""
    out = torch.zeros(shape)
    if axis in spec:
        d = spec.index(axis)
        part = shape[d] // (blocks if axis == "model" else 1)
        idx = (torch.arange(shape[d]) % part) // (part // size)
        out += idx.reshape([-1 if i == d else 1 for i in range(len(shape))])
    return out


def tiny_configs():
    return {"tiny": (JM.tiny_config(), TM.tiny_config()),
            "tiny_moe": (JM.tiny_moe_config(), TM.tiny_moe_config())}


def _port_layout(tcfg, sizes, fsdp, min_size):
    model = TM.MultiFrameMLLM(tcfg, device="meta")
    return model, TS.params_shardings(model, _port_mesh(sizes), fsdp,
                                      min_size)


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("config", ["tiny", "tiny_moe"])
def test_tiny_layout_holds_jax_shards_element_for_element(config, mesh,
                                                          fsdp):
    jcfg, tcfg = tiny_configs()[config]
    sizes = MESHES[mesh]
    jspecs = jax_specs(jcfg, sizes, fsdp, TINY_MIN)
    model, layout = _port_layout(tcfg, sizes, fsdp, TINY_MIN)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert set(layout) == set(shapes)
    sharded = 0
    for axis, size in sizes.items():
        coords = jax_params_to_state_dict(_tree({
            k: _coord_array(s, spec, axis, size)
            for k, (s, spec) in jspecs.items()}), jcfg)
        assert set(coords) == set(layout)
        for name, spec in layout.items():
            want = _port_coords(shapes[name], spec, axis, size,
                                TS._blocks(name))
            assert torch.equal(coords[name].float(), want), (name, axis,
                                                             spec)
            sharded += axis in spec and size > 1
    # a dense model on a mesh whose model axis is 1 shards only with FSDP
    assert sharded > 0 or (config == "tiny" and sizes["model"] == 1
                           and not fsdp)


def _norm(name: str) -> str:
    return re.sub(r"\.\d+\.", ".#.", name)


@functools.cache
def _dim_maps(jcfg) -> dict:
    """{port name with layer numbers as #: {JAX dim: port dim}} from the
    tiny config: JAX dim d maps to the port dim its index varies along."""
    jspecs = jax_specs(jcfg, {"data": 1}, False, TINY_MIN)
    out = {}
    for d in range(4):
        flat = {}
        for k, (s, _) in jspecs.items():
            a = np.zeros(s, np.float32)
            if d < len(s):
                a += np.arange(s[d]).reshape([-1 if i == d else 1
                                              for i in range(len(s))])
            flat[k] = a
        for name, t in jax_params_to_state_dict(_tree(flat), jcfg).items():
            varies = [p for p in range(t.dim()) if t.shape[p] > 1 and
                      not torch.equal(t, t.narrow(p, 0, 1).expand_as(t))]
            if varies:
                out.setdefault(_norm(name), {})[d] = varies[0]
    return out


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_flagship_layout_matches_jax(mesh, fsdp):
    """The flagship (8.075 B parameters, built on the meta device): every
    parameter's spec is JAX's, mapped to the port's dims."""
    sizes = MESHES[mesh]
    dims = _dim_maps(JM.tiny_config())
    jcfg = JM.flagship_config()
    jspecs = jax_specs(jcfg, sizes, fsdp, 2 ** 16)
    _, layout = _port_layout(TM.flagship_config(), sizes, fsdp, 2 ** 16)
    # the JAX path of each port name: leaves of one element carrying
    # their path's index through the converter
    order = sorted(jspecs)
    tagged = jax_params_to_state_dict(_tree(
        {k: np.full((1,) * len(jspecs[k][0]), i, np.float32)
         for i, k in enumerate(order)}), jcfg)
    jax_of = {name: order[int(t.reshape(-1)[0])]
              for name, t in tagged.items()}
    assert set(jax_of) == set(layout) and len(layout) == len(jspecs)
    n_sharded = 0
    for name, spec in layout.items():
        shape, jspec = jspecs[jax_of[name]]
        want = [None] * len(spec)
        for d, axis in enumerate(jspec):
            if axis is not None:
                want[dims[_norm(name)][d]] = axis
        assert tuple(want) == spec, (name, jspec, spec)
        n_sharded += any(a is not None and sizes.get(a, 1) > 1
                         for a in spec)
    # the dense flagship on a mesh whose model axis is 1 shards only with
    # FSDP (its expert tables are absent)
    assert n_sharded > 0 or (sizes["model"] == 1 and not fsdp)
    if fsdp and mesh == "4data_2model":
        # every large tensor of the flagship is sharded over data
        assert all("data" in spec for name, spec in layout.items()
                   if np.prod(jspecs[jax_of[name]][0]) >= 2 ** 16)


def test_shard_and_gather_round_trip_without_a_group():
    """`take_shard` over the coordinates of an axis, concatenated in the
    blocked order `gather_params` uses, gives the tensor back."""
    t = torch.arange(3 * 8 * 5, dtype=torch.float32).reshape(24, 5)
    parts = [TS.take_shard(t, 0, c, 2, blocks=3) for c in range(2)]
    per = [p.chunk(3, 0) for p in parts]
    back = torch.cat([per[r][b] for b in range(3) for r in range(2)], 0)
    assert torch.equal(back, t)
    assert torch.equal(parts[1][:4], t[4:8])
