"""Checkpoint import and export in the port (models/safetensors_io.py,
models/checkpoint_import.py, the `import-checkpoint` and
`export-checkpoint` commands) against the safetensors package and the JAX
package.

Bounds, all exact:
- `safetensors_io.save_file` writes the bytes of
  `safetensors.numpy.save_file` (0.8.0), and its reads equal `safe_open`'s
  tensor for tensor;
- the port's import of `make_fixture_state_dict` (with and without layer
  scales, cast at read time to float32 or bfloat16, or converted in
  memory) equals `jax_params_to_state_dict` of the JAX package's
  `convert_state_dict` bit for bit, with equal dtypes;
- the port CLI's import then export writes a directory byte-equal to the
  JAX CLI's, file for file (one shard, and several with the index).
"""

import json
import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.numpy import save_file as st_save_file

from multi_spatialmllm_tpu import __main__ as jcli
from multi_spatialmllm_tpu.models import checkpoint_import as JC
from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu_torch import __main__ as tcli
from multi_spatialmllm_tpu_torch.models import checkpoint_import as TC
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models import safetensors_io as S
from multi_spatialmllm_tpu_torch.models.convert import (
    _t,
    jax_params_to_state_dict,
)

NP_DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def _to_torch(a: np.ndarray) -> torch.Tensor:
    return _t(np.asarray(a))


def _arrays(seed: int) -> dict:
    """Mixed dtypes and shapes, a 0-d and an empty tensor among them, in
    an insertion order unlike the file's layout."""
    rng = np.random.default_rng(seed)
    return {
        "w.z": rng.standard_normal((7, 5)).astype(np.float32),
        "b16": rng.standard_normal((3, 4, 2)).astype(ml_dtypes.bfloat16),
        "a.half": rng.standard_normal(9).astype(np.float16),
        "ints": rng.integers(-9, 9, (4, 3)).astype(np.int32),
        "longs": rng.integers(-9, 9, (5,)).astype(np.int64),
        "scalar": np.full((), 1.5, np.float32),
        "empty": np.zeros((2, 0), np.float32),
        "Upper": rng.standard_normal((1, 1, 6)).astype(np.float32),
        "layer_10.x": rng.standard_normal(3).astype(ml_dtypes.bfloat16),
        "layer_2.x": rng.standard_normal(3).astype(ml_dtypes.bfloat16),
    }


# one metadata key: safetensors orders two or more by a hash map's
# iteration, which varies from run to run
@pytest.mark.parametrize("metadata", [None, {"format": "pt"}],
                         ids=["plain", "metadata"])
@pytest.mark.parametrize("seed", [0, 1])
def test_writer_bytes_equal_safetensors(tmp_path, seed, metadata):
    arrays = _arrays(seed)
    st_save_file(arrays, str(tmp_path / "want.safetensors"),
                 metadata=metadata)
    S.save_file({k: _to_torch(v) for k, v in arrays.items()},
                str(tmp_path / "got.safetensors"), metadata=metadata)
    assert (tmp_path / "got.safetensors").read_bytes() == \
        (tmp_path / "want.safetensors").read_bytes()


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13])
def test_header_padding_equals_safetensors(tmp_path, n):
    """Name lengths that walk the header through every padding remainder."""
    arrays = {"t" * n: np.ones((n,), np.float32),
              "u" * (n + 1): np.ones((1, n), ml_dtypes.bfloat16)}
    st_save_file(arrays, str(tmp_path / "want"))
    S.save_file({k: _to_torch(v) for k, v in arrays.items()},
                str(tmp_path / "got"))
    assert (tmp_path / "got").read_bytes() == (tmp_path / "want").read_bytes()


@pytest.mark.parametrize("cast", [None, torch.float32, torch.bfloat16])
def test_reader_equals_safe_open(tmp_path, cast):
    arrays = _arrays(3)
    arrays = {k: v for k, v in arrays.items()
              if v.dtype in (np.float32, ml_dtypes.bfloat16)}
    path = str(tmp_path / "x.safetensors")
    st_save_file(arrays, path)
    got = S.load_file(path, dtype=cast)
    with safe_open(path, framework="np") as f:
        assert sorted(f.keys()) == sorted(got)
        for k in f.keys():
            want = f.get_tensor(k)
            if cast is not None:
                want = np.asarray(want, dtype=NP_DTYPES[str(cast)[6:]])
            assert got[k].dtype == (cast or _to_torch(want).dtype)
            assert torch.equal(got[k], _to_torch(want)), k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer_scale", [True, False],
                         ids=["ls", "no_ls"])
def test_import_equals_jax(tmp_path, dtype, layer_scale):
    """The read-time cast (load_internvl2_checkpoint over two shards) and
    the in-memory conversion of float32 tensors both equal JAX's."""
    jcfg, tcfg = JM.tiny_config(), TM.tiny_config()
    state = JC.make_fixture_state_dict(jcfg, 5, layer_scale)
    names = list(state)
    st_save_file({k: state[k] for k in names[:20]},
                 str(tmp_path / "a.safetensors"))
    st_save_file({k: state[k] for k in names[20:]},
                 str(tmp_path / "b.safetensors"))
    npd, td = NP_DTYPES[dtype], getattr(torch, dtype)
    want = jax_params_to_state_dict(JC.load_internvl2_checkpoint(
        str(tmp_path), jcfg, param_dtype=npd), jcfg)
    got = TC.load_internvl2_checkpoint(str(tmp_path), tcfg, td)
    want_mem = jax_params_to_state_dict(
        JC.convert_state_dict(state, jcfg, npd), jcfg)
    got_mem = TC.convert_state_dict(
        {k: torch.from_numpy(v) for k, v in state.items()}, tcfg, td)
    for w, g in ((want, got), (want_mem, got_mem)):
        assert set(g) == set(TM.MultiFrameMLLM(tcfg).state_dict())
        for k in w:
            assert g[k].dtype == w[k].dtype == td, k
            assert torch.equal(g[k], w[k]), k


def test_fixture_equals_jax():
    for ls in (True, False):
        a = JC.make_fixture_state_dict(JM.tiny_config(), 2, ls)
        b = TC.make_fixture_state_dict(TM.tiny_config(), 2, ls)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_export_round_trip_and_order():
    """export_state_dict inverts the import (layer scales folded) and
    keeps the JAX export's key order."""
    cfg = TM.tiny_config()
    state = TC.make_fixture_state_dict(cfg, 4, with_layer_scale=False)
    sd = TC.convert_state_dict({k: torch.from_numpy(v)
                                for k, v in state.items()}, cfg)
    back = TC.export_state_dict(sd, cfg)
    jparams = JC.convert_state_dict(state, JM.tiny_config())
    assert list(back) == list(JC.export_state_dict(jparams,
                                                   JM.tiny_config()))
    for k, v in state.items():
        assert torch.equal(back[k], torch.from_numpy(v)), k


def _jax_cli(monkeypatch, argv):
    monkeypatch.setattr("sys.argv", ["prog", *argv])
    jcli.main()


@pytest.mark.parametrize("imp,exp,shard_gb", [
    ("float32", "float32", "4.0"), ("float32", "bfloat16", "0.0003"),
    ("bfloat16", "bfloat16", "0.0003"), ("bfloat16", "float32", "4.0")],
    ids=["f32-f32-one", "f32-bf16-shards", "bf16-bf16-shards",
         "bf16-f32-one"])
def test_cli_import_export_byte_equal_to_jax(tmp_path, monkeypatch, capsys,
                                             imp, exp, shard_gb):
    """`import-checkpoint` then `export-checkpoint`, JAX CLI and port CLI
    (on the CPU) on one fixture file: the same files with the same bytes,
    the index included, and the same printed summaries."""
    src = str(tmp_path / "hf.safetensors")
    st_save_file(JC.make_fixture_state_dict(JM.tiny_config(), 6), src)
    _jax_cli(monkeypatch, ["import-checkpoint", "--checkpoint", src,
                           "--output", str(tmp_path / "j_orbax"),
                           "--config", "tiny", "--dtype", imp])
    _jax_cli(monkeypatch, ["export-checkpoint", "--checkpoint",
                           str(tmp_path / "j_orbax"), "--output",
                           str(tmp_path / "j_hf"), "--config", "tiny",
                           "--dtype", exp, "--shard-gb", shard_gb])
    j_out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    tcli.main(["import-checkpoint", "--checkpoint", src, "--output",
               str(tmp_path / "t.pt"), "--config", "tiny", "--dtype", imp,
               "--device", "cpu"])
    tcli.main(["export-checkpoint", "--checkpoint", str(tmp_path / "t.pt"),
               "--output", str(tmp_path / "t_hf"), "--config", "tiny",
               "--dtype", exp, "--shard-gb", shard_gb, "--device", "cpu"])
    t_out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    for j, t in zip(j_out, t_out):
        assert {k: v for k, v in j.items() if k != "output"} == \
            {k: v for k, v in t.items() if k != "output"}
    files = sorted(os.listdir(tmp_path / "j_hf"))
    assert files == sorted(os.listdir(tmp_path / "t_hf"))
    assert (len(files) > 2) == (shard_gb != "4.0")
    for f in files:
        assert (tmp_path / "t_hf" / f).read_bytes() == \
            (tmp_path / "j_hf" / f).read_bytes(), f


def test_export_of_a_train_save_and_the_moe_refusal(tmp_path, monkeypatch):
    """A train save's params export as a state dict does; a routed-MoE
    state dict is refused with the JAX CLI's message."""
    from multi_spatialmllm_tpu.parallel.train import save_checkpoint
    from multi_spatialmllm_tpu_torch.parallel.train import (
        save_checkpoint_rolling,
    )

    cfg = TM.with_dtype(TM.tiny_config(), "float32")
    model = TM.MultiFrameMLLM(cfg)
    TM.init_random_weights(model, 0)
    save_checkpoint_rolling(str(tmp_path / "run"), model, step=3)
    torch.save(model.state_dict(), tmp_path / "sd.pt")
    for src, out in (("run", "a"), ("sd.pt", "b")):
        tcli.main(["export-checkpoint", "--checkpoint", str(tmp_path / src),
                   "--output", str(tmp_path / out), "--config", "tiny",
                   "--device", "cpu"])
    assert (tmp_path / "a" / "model.safetensors").read_bytes() == \
        (tmp_path / "b" / "model.safetensors").read_bytes()

    jcfg = JM.tiny_moe_config()
    batch = JM.make_example_batch(jcfg, batch=1, n_tiles=1, seq_len=64)
    jparams = jax.jit(JM.MultiFrameMLLM(jcfg).init)(
        jax.random.key(0), batch["input_ids"], batch["tiles"])
    save_checkpoint(str(tmp_path / "j_moe"), jparams, step=1)
    with pytest.raises(SystemExit) as want:
        _jax_cli(monkeypatch, ["export-checkpoint", "--checkpoint",
                               str(tmp_path / "j_moe"), "--output",
                               str(tmp_path / "jc"), "--config", "tiny"])
    moe = TM.MultiFrameMLLM(TM.tiny_moe_config())
    torch.save(moe.state_dict(), tmp_path / "moe.pt")
    with pytest.raises(SystemExit) as got:
        tcli.main(["export-checkpoint", "--checkpoint",
                   str(tmp_path / "moe.pt"), "--output",
                   str(tmp_path / "c"), "--config", "tiny", "--device",
                   "cpu"])
    assert str(got.value) == str(want.value)
    assert not (tmp_path / "c").exists()


def test_random_state_dict_matches_the_fixture_layout():
    cfg = TM.tiny_config()
    a = TC.random_state_dict(cfg, 0, dtype=torch.bfloat16)
    b = TC.make_fixture_state_dict(cfg, 0)
    assert list(a) == list(b)
    for k in a:
        assert tuple(a[k].shape) == b[k].shape and a[k].dtype == \
            torch.bfloat16
    sd = TC.convert_state_dict(a, cfg, torch.bfloat16)
    model = TM.MultiFrameMLLM(cfg)
    model.load_state_dict(sd)
    assert jax.tree_util.tree_leaves(0) == [0]   # jax stays importable
