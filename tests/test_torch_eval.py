"""The port's MultiSPA evaluation (models/runner.py and the `eval`
command) against the JAX package's, at the tiny config in float32 with the
same weights (a Flax init saved as an orbax checkpoint for the JAX CLI and
moved with `models/convert.py` into a torch save for the port's) and the
same campaign: records over JPEG frames on disk, read by cv2 in the JAX
package and by ingest/image.py in the port (pixel-equal).

The `--output` report JSON (scores, counts, predictions) must be equal
byte for byte for each flag set of the JAX CLI; with `--logprobs` the
predictions are equal and the confidences within LOGPROB_ATOL. The
printed `serving_stats` hold JAX's counters with JAX's values."""

import contextlib
import dataclasses
import io
import json
import os
import sys

import jax
import numpy as np
import pytest

from multi_spatialmllm_tpu import __main__ as JC
from multi_spatialmllm_tpu.models import mllm as JM
from multi_spatialmllm_tpu.models import runner as JR
from multi_spatialmllm_tpu.models.tokenizer import SpatialTokenizer
from multi_spatialmllm_tpu_torch import __main__ as TC
from multi_spatialmllm_tpu_torch.models import mllm as TM
from multi_spatialmllm_tpu_torch.models import runner as TR
from multi_spatialmllm_tpu_torch.models.convert import (
    jax_params_to_state_dict,
)
from test_torch_generate import f32
from test_torch_generate import one_torch_thread  # noqa: F401 (autouse)

LOGPROB_ATOL = 1e-5
TOK = SpatialTokenizer()
STEM = ("These are two views of one indoor scene and every distance in "
        "your answer must be reported in millimeters measured from the "
        "first camera center. ")


def records():
    """Two images x three questions sharing a long stem (the prefix cache's
    shape), and two multiple-choice records over both images."""
    out = []
    for i in range(2):
        for q in range(3):
            out.append({"id": f"{i}-{q}", "image": [f"{i}.jpg"],
                        "text": f"<image>\n{STEM}Question variant {q} here?",
                        "question_type": "depth_estimation_coor",
                        "gt_value": 900 + q, "height_list": [96],
                        "width_list": [128]})
        out.append({"id": f"{i}-mc", "image": [f"{i}.jpg", f"{1 - i}.jpg"],
                    "text": "<image>\n<image>\nWhich point corresponds?",
                    "question_type": "visual_correspondence_multiple_choice",
                    "gt_value": "A", "height_list": [96, 96],
                    "width_list": [128, 128]})
    return out


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """(root, JAX config, JAX model, params, port model): the checkpoints,
    frames and eval JSONL under root. The vocabulary is the tokenizer's
    own, so every generated id decodes."""
    import cv2

    from multi_spatialmllm_tpu.parallel.train import save_checkpoint

    root = tmp_path_factory.mktemp("eval")
    base = f32(JM.tiny_config())
    cfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, vocab_size=TOK.vocab_size))
    jmodel = JM.MultiFrameMLLM(cfg)
    b = JM.make_example_batch(cfg, batch=1, n_tiles=1, seq_len=64)
    params = jax.jit(jmodel.init)(jax.random.key(0), b["input_ids"],
                                  b["tiles"])
    save_checkpoint(str(root / "ckpt"), params)
    sd = jax_params_to_state_dict(params, cfg)
    import torch

    torch.save(sd, root / "ckpt.pt")
    tcfg = f32(TM.tiny_config())
    tmodel = TM.MultiFrameMLLM(dataclasses.replace(
        tcfg, llm=dataclasses.replace(tcfg.llm, vocab_size=TOK.vocab_size)))
    tmodel.load_state_dict(sd)
    tmodel.eval()
    (root / "imgs").mkdir()
    rng = np.random.default_rng(4)
    for i in range(2):
        cv2.imwrite(str(root / "imgs" / f"{i}.jpg"),
                    rng.integers(0, 255, (96, 128, 3), dtype=np.uint8))
    (root / "eval.jsonl").write_text(
        "\n".join(json.dumps(r) for r in records()))
    tree = root / "evaluation_data"
    for engine, qt, gt in (("depth_perception", "depth_estimation_coor", 900),
                           ("camera_movement", "x_movement", "left")):
        d = tree / engine
        d.mkdir(parents=True)
        recs = [dict(r, question_type=qt, gt_value=gt)
                for r in records()[:3]]
        (d / "val.jsonl").write_text("\n".join(json.dumps(r) for r in recs))
        (d / "val_orig.jsonl").write_text(
            "\n".join(json.dumps(r) for r in recs * 20))
    return root, cfg, jmodel, params, tmodel


def loader(root):
    def load(path):
        from multi_spatialmllm_tpu_torch.__main__ import _read_image

        return _read_image(os.path.join(root, "imgs", path))
    return load


def run_config(mc=False, speculate=0):
    from multi_spatialmllm_tpu.models.data import DataConfig as JD
    from multi_spatialmllm_tpu.models.preprocess import (
        PreprocessConfig as JP,
    )
    from multi_spatialmllm_tpu_torch.models.data import DataConfig as TD
    from multi_spatialmllm_tpu_torch.models.preprocess import (
        PreprocessConfig as TP,
    )

    kw = dict(max_new_tokens=5, length_bucket=32, mc_logprob=mc,
              speculate=speculate)
    return (JR.EvalRunConfig(**kw, data=JD(preprocess=JP(
                tile_size=56, max_tiles=1, resize_hw=None))),
            TR.EvalRunConfig(**kw, data=TD(preprocess=TP(
                tile_size=56, max_tiles=1, resize_hw=None))))


@pytest.mark.parametrize("batch_size,mc,speculate", [
    (1, False, 0), (3, False, 0), (1, True, 2), (4, True, 0)])
def test_run_eval_matches_jax(campaign, batch_size, mc, speculate):
    root, cfg, jmodel, params, tmodel = campaign
    jcfg, tcfg = run_config(mc, speculate)
    load = loader(root)
    want = JR.run_eval(jmodel, params, TOK, records(), load, jcfg,
                       batch_size=batch_size)
    got = TR.run_eval(tmodel, TOK, records(), load, tcfg,
                      batch_size=batch_size)
    assert got == want
    if mc:
        assert got["predictions"][3] in ("A", "B", "C", "D")


def test_score_candidates_match_jax(campaign):
    root, cfg, jmodel, params, tmodel = campaign
    jcfg, tcfg = run_config(mc=True)
    rec = records()[3]
    cands = ["A", "B", "C", "D", "left"]
    want = JR.score_candidates(jmodel, params, TOK, rec, cands,
                               loader(root), jcfg)
    got = TR.score_candidates(tmodel, TOK, rec, cands, loader(root), tcfg)
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGPROB_ATOL)
    assert int(np.argmax(got)) == int(np.argmax(want))


def test_predict_with_batchers_match_jax(campaign):
    """Paged (prefix cache, logprobs) and continuous batchers through the
    runner: JAX's predictions and confidences."""
    from multi_spatialmllm_tpu.models import paged_kv as JK
    from multi_spatialmllm_tpu.models import serving as JS
    from multi_spatialmllm_tpu_torch.models import paged_kv as TK
    from multi_spatialmllm_tpu_torch.models import serving as TS

    root, cfg, jmodel, params, tmodel = campaign
    jcfg, tcfg = run_config()
    pc = dict(slots=2, page_size=16, num_pages=64, max_prompt_len=128,
              max_new_tokens=5, chunk=2, length_bucket=32,
              prefix_cache=True, logprobs=True)
    sc = dict(slots=2, max_prompt_len=128, max_new_tokens=5, chunk=2,
              length_bucket=32)
    for jb, tb in (
            (JK.PagedBatcher(jmodel, params, JK.PagedConfig(**pc),
                             pad_id=TOK.pad_id, eos_id=TOK.eos_id),
             TK.PagedBatcher(tmodel, TK.PagedConfig(**pc),
                             pad_id=TOK.pad_id, eos_id=TOK.eos_id)),
            (JS.ContinuousBatcher(jmodel, params, JS.ServeConfig(**sc),
                                  pad_id=TOK.pad_id, eos_id=TOK.eos_id),
             TS.ContinuousBatcher(tmodel, TS.ServeConfig(**sc),
                                  pad_id=TOK.pad_id, eos_id=TOK.eos_id))):
        want = JR.run_eval(jmodel, params, TOK, records(), loader(root),
                           jcfg, batcher=jb)
        got = TR.run_eval(tmodel, TOK, records(), loader(root), tcfg,
                          batcher=tb)
        assert got["predictions"] == want["predictions"]
        if "confidences" in want:
            np.testing.assert_allclose(
                [c for c in got["confidences"] if c is not None],
                [c for c in want["confidences"] if c is not None],
                rtol=0, atol=LOGPROB_ATOL)
            assert tb.stats["prefill_resumed"] > 0


def run_cli(campaign, monkeypatch, package, args):
    """One `eval` of `package` ("jax" or "port") -> (the --output file's
    text, the printed report)."""
    root = campaign[0]
    out = root / f"report_{package}.json"
    argv = ["eval", "--config", "tiny", "--vocab-size", str(TOK.vocab_size),
            "--images-root", str(root / "imgs"), "--output", str(out),
            "--max-new-tokens", "6", "--max-tiles", "1", *args]
    buf = io.StringIO()
    with monkeypatch.context() as m, contextlib.redirect_stdout(buf):
        if package == "jax":
            tiny = JM.tiny_config
            m.setattr(JM, "tiny_config", lambda: f32(tiny()))
            m.setattr(sys, "argv", ["multi_spatialmllm_tpu", *argv,
                                    "--checkpoint", str(root / "ckpt")])
            JC.main()
        else:
            tiny = TM.CONFIGS["tiny"]
            m.setitem(TM.CONFIGS, "tiny", lambda: f32(tiny()))
            TC.main([*argv, "--checkpoint", str(root / "ckpt.pt"),
                     "--device", "cpu"])
    return out.read_text(), json.loads(buf.getvalue().splitlines()[-1])


PAGED = ["--paged", "--slots", "2", "--page-size", "16", "--num-pages",
         "64", "--max-prompt-len", "128"]
FLAG_SETS = {
    "batch1": ["--batch-size", "1"], "batch4": ["--batch-size", "4"],
    "speculate": ["--speculate", "3"], "mc_logprob": ["--mc-logprob"],
    "prefix_cache": PAGED + ["--prefix-cache"],
    "prefill_chunk": PAGED + ["--prefill-chunk", "16"],
    "vision_cache": PAGED + ["--prefill-chunk", "16", "--vision-cache", "2"],
    "paged_speculate": PAGED + ["--speculate", "3"],
    "int8_kv": PAGED + ["--kv-dtype", "int8", "--prefix-cache"],
    "logprobs": PAGED + ["--logprobs"],
    "quantize_weights": PAGED + ["--quantize-weights"],
}


@pytest.mark.parametrize("name", list(FLAG_SETS))
def test_eval_cli_report_equals_jax(campaign, monkeypatch, name):
    args = ["--eval-jsonl", str(campaign[0] / "eval.jsonl"),
            *FLAG_SETS[name]]
    want, jprinted = run_cli(campaign, monkeypatch, "jax", args)
    got, tprinted = run_cli(campaign, monkeypatch, "port", args)
    if name == "logprobs":
        w, g = json.loads(want), json.loads(got)
        np.testing.assert_allclose(g.pop("confidences"),
                                   w.pop("confidences"), atol=LOGPROB_ATOL)
        np.testing.assert_allclose(g.pop("mean_token_logprob"),
                                   w.pop("mean_token_logprob"),
                                   atol=LOGPROB_ATOL)
        assert g == w
    else:
        assert got == want
    if "serving_stats" in jprinted:
        stats = tprinted["serving_stats"]
        assert {k: stats[k] for k in jprinted["serving_stats"]} \
            == jprinted["serving_stats"]
    if name == "vision_cache":
        assert tprinted["serving_stats"]["vision_hits"] >= 2


def test_eval_cli_eval_root_equals_jax(campaign, monkeypatch):
    """--eval-root: per-engine reports and the weighted aggregate, the
    *_orig.jsonl dumps skipped, as the JAX CLI reports them."""
    args = ["--eval-root", str(campaign[0] / "evaluation_data"),
            "--batch-size", "2"]
    want, _ = run_cli(campaign, monkeypatch, "jax", args)
    got, printed = run_cli(campaign, monkeypatch, "port", args)
    assert got == want
    assert printed["count"] == 6
    assert set(printed["engines"]) == {"camera_movement",
                                       "depth_perception"}
