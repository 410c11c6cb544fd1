"""Import boundary and build rules of the port: importing every module of
multi_spatialmllm_tpu_torch loads neither jax nor the JAX package, its
`train` and `serve` commands run end to end with that package made
unimportable (and with cv2 unimportable too, on JPEG and PNG frames, with
a torch.profiler trace of the training steps), and its `demo` command
runs the whole data engine (the ScanNet engines and the TAPVid
object-movement engines), its `tapvid` command, and its `ingest-scannet`,
`ingest-sens`, `coverage` and `pipeline --trace-dir` commands run with the
card's installation simulated (no jax, flax, optax, orbax, cv2, pandas,
pyarrow or JAX package) and write the files of a run with cv2 importable;
`import-checkpoint`, `export-checkpoint`, `train --lora-rank` and a
mixed-adapter paged batcher run with safetensors and ml_dtypes
unimportable too; a kernel build on a host without CUDA raises instead of
falling back; a library's name changes with its shared headers; a
misaligned operand raises before any launch; and chip_smoke.py refuses to
run (non-zero exit, no result line) without a CUDA device or outside the
repository."""

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from multi_spatialmllm_tpu.models import tokenizer as JT
from multi_spatialmllm_tpu_torch.dryrun import free_port
from multi_spatialmllm_tpu_torch.models import runner as TR
from multi_spatialmllm_tpu_torch.ops import _build as TB
from multi_spatialmllm_tpu_torch.ops import attention as TA
from multi_spatialmllm_tpu_torch.ops import grouped_matmul as TG
from multi_spatialmllm_tpu_torch.ops import paged_attention as TP

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_MODULES = [
    "multi_spatialmllm_tpu_torch",
    "multi_spatialmllm_tpu_torch.__main__",
    "multi_spatialmllm_tpu_torch.core",
    "multi_spatialmllm_tpu_torch.dryrun",
    "multi_spatialmllm_tpu_torch.core.boxes",
    "multi_spatialmllm_tpu_torch.core.geometry",
    "multi_spatialmllm_tpu_torch.core.io",
    "multi_spatialmllm_tpu_torch.core.rng",
    "multi_spatialmllm_tpu_torch.core.scene",
    "multi_spatialmllm_tpu_torch.core.synthetic",
    "multi_spatialmllm_tpu_torch.engines._glyphs",
    "multi_spatialmllm_tpu_torch.engines.annotate",
    "multi_spatialmllm_tpu_torch.engines.base",
    "multi_spatialmllm_tpu_torch.engines.camera_movement",
    "multi_spatialmllm_tpu_torch.engines.depth_perception",
    "multi_spatialmllm_tpu_torch.engines.draw",
    "multi_spatialmllm_tpu_torch.engines.fast_jsonl",
    "multi_spatialmllm_tpu_torch.engines.object_movement",
    "multi_spatialmllm_tpu_torch.engines.object_perception",
    "multi_spatialmllm_tpu_torch.engines.sampling",
    "multi_spatialmllm_tpu_torch.engines.templates",
    "multi_spatialmllm_tpu_torch.engines.templates.camera_movement",
    "multi_spatialmllm_tpu_torch.engines.templates.correspondence",
    "multi_spatialmllm_tpu_torch.engines.templates.depth",
    "multi_spatialmllm_tpu_torch.engines.templates.object_movement",
    "multi_spatialmllm_tpu_torch.engines.templates.object_perception",
    "multi_spatialmllm_tpu_torch.engines.visual_correspondence",
    "multi_spatialmllm_tpu_torch.ingest.image",
    "multi_spatialmllm_tpu_torch.ingest.jpeg",
    "multi_spatialmllm_tpu_torch.ingest.native",
    "multi_spatialmllm_tpu_torch.ingest.ply",
    "multi_spatialmllm_tpu_torch.ingest.png",
    "multi_spatialmllm_tpu_torch.ingest.posed_images",
    "multi_spatialmllm_tpu_torch.ingest.scannet_export",
    "multi_spatialmllm_tpu_torch.ingest.sens",
    "multi_spatialmllm_tpu_torch.ingest.synthetic_scan",
    "multi_spatialmllm_tpu_torch.ingest.tapvid",
    "multi_spatialmllm_tpu_torch.pipeline",
    "multi_spatialmllm_tpu_torch.stages.coverage",
    "multi_spatialmllm_tpu_torch.stages.frame_relations",
    "multi_spatialmllm_tpu_torch.stages.manifest",
    "multi_spatialmllm_tpu_torch.stages.object_visibility",
    "multi_spatialmllm_tpu_torch.stages.visibility",
    "multi_spatialmllm_tpu_torch.utils.flops",
    "multi_spatialmllm_tpu_torch.utils.logging",
    "multi_spatialmllm_tpu_torch.utils.profiling",
    "multi_spatialmllm_tpu_torch.ops._build",
    "multi_spatialmllm_tpu_torch.ops.attention",
    "multi_spatialmllm_tpu_torch.ops.grouped_matmul",
    "multi_spatialmllm_tpu_torch.ops.paged_attention",
    "multi_spatialmllm_tpu_torch.ops.ring_attention",
    "multi_spatialmllm_tpu_torch.models._vocab_templates",
    "multi_spatialmllm_tpu_torch.models.checkpoint_import",
    "multi_spatialmllm_tpu_torch.models.convert",
    "multi_spatialmllm_tpu_torch.models.data",
    "multi_spatialmllm_tpu_torch.models.eval_harness",
    "multi_spatialmllm_tpu_torch.models.generate",
    "multi_spatialmllm_tpu_torch.models.llm",
    "multi_spatialmllm_tpu_torch.models.mixture",
    "multi_spatialmllm_tpu_torch.models.mllm",
    "multi_spatialmllm_tpu_torch.models.moe",
    "multi_spatialmllm_tpu_torch.models.paged_kv",
    "multi_spatialmllm_tpu_torch.models.preprocess",
    "multi_spatialmllm_tpu_torch.models.prng",
    "multi_spatialmllm_tpu_torch.models.quantize",
    "multi_spatialmllm_tpu_torch.models.resize",
    "multi_spatialmllm_tpu_torch.models.runner",
    "multi_spatialmllm_tpu_torch.models.safetensors_io",
    "multi_spatialmllm_tpu_torch.models.serving",
    "multi_spatialmllm_tpu_torch.models.tokenizer",
    "multi_spatialmllm_tpu_torch.models.vit",
    "multi_spatialmllm_tpu_torch.parallel",
    "multi_spatialmllm_tpu_torch.parallel.distributed",
    "multi_spatialmllm_tpu_torch.parallel.lora",
    "multi_spatialmllm_tpu_torch.parallel.lora_serving",
    "multi_spatialmllm_tpu_torch.parallel.mesh",
    "multi_spatialmllm_tpu_torch.parallel.pipeline_mllm",
    "multi_spatialmllm_tpu_torch.parallel.pipeline_parallel",
    "multi_spatialmllm_tpu_torch.parallel.sharding",
    "multi_spatialmllm_tpu_torch.parallel.train",
]
# the card has neither safetensors nor ml_dtypes: the port reads and writes
# safetensors files and bfloat16 without them
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "multi_spatialmllm_tpu",
           "safetensors", "ml_dtypes")
KERNELS = [TA.FLASH_FWD, TA.FLASH_BWD_DQ, TA.FLASH_BWD_DKV, TP.PAGED_DECODE,
           TP.PAGED_DECODE_INT8, TG.GMM, TG.GMM_T, TG.TGMM]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_never_imports_jax_or_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BLOCKED!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], env=_env(),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_prompt_markers_match_the_jax_tokenizer():
    for name in ("IMG_CONTEXT", "IMG_START", "IMG_END", "HUMAN",
                 "ASSISTANT"):
        assert getattr(TR, name) == getattr(JT, name), name


# a finder that refuses the JAX package and JAX itself (or `blocked`): any
# import of them (lazy ones included) fails the run
def _blocker(blocked=None, body="from multi_spatialmllm_tpu_torch.__main__ "
                                 "import main\nmain(sys.argv[1:])"):
    return textwrap.dedent(f"""
    import importlib.abc, importlib.machinery, sys

    class Refuse(importlib.abc.MetaPathFinder, importlib.abc.Loader):
        # a blocked module's spec has no origin and a loader that raises:
        # importing it fails, and a probe by importlib.util.find_spec (as
        # torch.profiler's imports make) passes it over
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in {blocked or BLOCKED!r}:
                return importlib.machinery.ModuleSpec(name, self)
            return None

        def create_module(self, spec):
            raise ImportError("blocked: " + spec.name)

        def exec_module(self, module):
            pass

    sys.meta_path.insert(0, Refuse())
""") + body + "\n"


def _run_blocked(args, tmp_path, stdin="", blocked=None, **kw):
    proc = subprocess.run([sys.executable, "-c", _blocker(blocked, **kw),
                           *args],
                          env=_env(), cwd=tmp_path, input=stdin,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return [json.loads(ln) for ln in proc.stdout.splitlines()
            if ln.startswith("{")]


def _write_mixture(tmp_path, ext=("png",)):
    """Six one-image records and their frames under `tmp_path` (written by
    cv2; record i's frame in the format ext[i % len(ext)])."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(3)
    (tmp_path / "imgs").mkdir()
    recs = []
    for i in range(6):
        name = f"im{i}.{ext[i % len(ext)]}"
        cv2.imwrite(str(tmp_path / "imgs" / name),
                    rng.integers(0, 255, (56, 56, 3), dtype=np.uint8))
        recs.append({"id": f"s{i}", "image": [name],
                     "conversations": [
                         {"from": "human",
                          "value": "<image>\nhow far is the point?"},
                         {"from": "gpt", "value": f"{100 + i} mm"}]})
    (tmp_path / "train.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    (tmp_path / "mix.json").write_text(json.dumps(
        {"spa": {"root": "imgs", "annotation": "train.jsonl",
                 "repeat_time": 1}}))


def _train_then_serve(tmp_path, model_flags=(), serve_flags=(),
                      train_flags=(), ext=("png",), blocked=None):
    """`train` (packed rows, accumulation, a rolling checkpoint) then
    `serve` from that checkpoint, on the tiny config on the CPU, with the
    JAX package (or `blocked`) unimportable."""
    _write_mixture(tmp_path, ext)
    out = tmp_path / "ckpt"
    [report] = _run_blocked(
        ["train", "--meta", "mix.json", "--config", "tiny", "--device",
         "cpu", "--steps", "2", "--batch-size", "2", "--accum", "2",
         "--seq-len", "128", "--max-tiles", "2", "--tiles-per-image", "1",
         "--packed", "--warmup", "1", "--lr", "1e-3", "--log-every", "1",
         "--vocab-size", "800", "--output", str(out), *model_flags,
         *train_flags], tmp_path, blocked=blocked)
    assert report["steps"] == 2 and report["device"] == "cpu"
    assert all(v is not None for v in report.values())
    assert (out / "LATEST").read_text().strip() == "step_00000002"

    lines = "".join(json.dumps({"id": f"q{i}", "image": [
        f"im{i}.{ext[i % len(ext)]}"], "text": "<image>\nhow far?"}) + "\n"
                    for i in range(2))
    results = _run_blocked(
        ["serve", "--checkpoint", str(out), "--config", "tiny", "--device",
         "cpu", "--vocab-size", "800", "--images-root", "imgs",
         "--max-new-tokens", "4", "--slots", "2", "--page-size", "16",
         "--num-pages", "32", "--max-prompt-len", "128", *model_flags,
         *serve_flags], tmp_path, stdin=lines, blocked=blocked)
    assert sorted(r["id"] for r in results) == ["q0", "q1"]
    assert all(0 < len(r["token_ids"]) <= 4 for r in results)


def test_train_and_serve_run_with_the_jax_package_unimportable(tmp_path):
    _train_then_serve(tmp_path)


def test_train_and_serve_read_jpeg_and_png_without_cv2(tmp_path):
    """`train --trace-dir` and `serve` on JPEG and PNG frames with cv2,
    jax and the JAX package unimportable: the frames are read by
    ingest/image.py and resized by models/resize.py, and the training
    steps leave a torch.profiler trace."""
    _train_then_serve(tmp_path, train_flags=["--trace-dir", "trace"],
                      ext=("jpg", "png"), blocked=_CARD_BLOCKED)
    [trace] = os.listdir(tmp_path / "trace")
    assert json.loads((tmp_path / "trace" / trace).read_text())[
        "traceEvents"]


def test_moe_train_and_int8_serve_run_with_the_jax_package_unimportable(
        tmp_path):
    """The MoE slice's commands: `train --moe-experts 4 --moe-impl ragged
    --moe-kernel pallas`, then `serve` of that checkpoint with the same
    flags and int8 kv pools."""
    _train_then_serve(
        tmp_path, ["--moe-experts", "4", "--moe-impl", "ragged",
                   "--moe-kernel", "pallas"], ["--kv-dtype", "int8"])


def test_train_mesh_flags_run_with_the_jax_package_unimportable(tmp_path):
    """`train` with each mesh flag (`--model-parallel 2`, `--seq-parallel
    2`, `--expert-parallel 2` with the einsum MoE, `--fsdp --data-parallel
    2`) in one world launched by `torch.distributed.run --nproc-per-node 2`
    on the CPU, one run after another, packed rows in two microbatches,
    with the JAX package unimportable in every process."""
    from torch_mesh_ranks import SEQUENTIAL_TRAIN, split_runs

    _write_mixture(tmp_path)
    (tmp_path / "blocked_train.py").write_text(_blocker(
        body=SEQUENTIAL_TRAIN))
    flags = {"model": ["--model-parallel", "2"],
             "seq": ["--seq-parallel", "2"],
             "expert": ["--expert-parallel", "2", "--moe-experts", "4",
                        "--moe-impl", "einsum"],
             "data": ["--fsdp", "--data-parallel", "2"]}
    runs = [["train", "--meta", "mix.json", "--config", "tiny", "--device",
             "cpu", "--steps", "2", "--batch-size", "4", "--accum", "2",
             "--seq-len", "128", "--max-tiles", "2", "--tiles-per-image",
             "1", "--packed", "--warmup", "1", "--lr", "1e-3",
             "--vocab-size", "800", "--output", str(tmp_path / f"ckpt_{a}"),
             *f] for a, f in flags.items()]
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "localhost", "--master-port",
         str(free_port()), "blocked_train.py", json.dumps(runs)],
        env=dict(_env(), OMP_NUM_THREADS="1"), cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    outs = split_runs(proc.stdout, len(runs))
    for axis, out in zip(flags, outs):
        [report] = [json.loads(ln) for ln in out.splitlines()
                    if ln.startswith("{")]
        assert report["steps"] == 2 and report["mesh"][axis] == 2, report
        assert (tmp_path / f"ckpt_{axis}" / "LATEST").exists()


_ADAPTER_SERVE = """
import json, sys
import numpy as np, torch
from multi_spatialmllm_tpu_torch.models import mllm as M, paged_kv as K, prng
from multi_spatialmllm_tpu_torch.parallel import lora as L
from multi_spatialmllm_tpu_torch.__main__ import _config, build_parser
args = build_parser().parse_args(["serve", "--checkpoint", sys.argv[1],
                                  "--config", "tiny", "--vocab-size", "800",
                                  "--device", "cpu"])
cfg = _config(args)
model = M.MultiFrameMLLM(cfg)
model.load_state_dict(torch.load(sys.argv[1]))
lc = L.LoRAConfig(rank=2, targets=("wq", "wv", "gate", "down"))
ads = {}
for i, name in enumerate(("a", "b")):
    ad = L.init_lora(model, lc, prng.key(i))
    for t in ad.values():
        t["b"].normal_(0.0, 0.5, generator=torch.Generator().manual_seed(i))
    ads[name] = ad
reqs = K.make_serve_requests(cfg, 4, seed=1)
reqs = [r + (("a", "b", None, "a")[i],) if i != 2 else r
        for i, r in enumerate(reqs)]
pcfg = K.PagedConfig(slots=2, page_size=16, num_pages=64,
                     max_prompt_len=256, max_new_tokens=4,
                     length_bucket=64, prefix_cache=True, prefill_chunk=16,
                     speculate=2, kv_dtype="int8")
got = K.PagedBatcher(model, pcfg, adapters=ads,
                     lora_config=lc).generate_all(reqs)
print(json.dumps({"tokens": [g.tolist() for g in got]}))
"""


def test_checkpoint_lora_and_adapter_serving_run_with_the_cards_installation(
        tmp_path):
    """`import-checkpoint` of HF safetensors shards, `export-checkpoint`,
    `train --lora-rank` from the imported weights and a mixed-adapter
    PagedBatcher, with jax, the JAX package, safetensors, ml_dtypes and cv2
    unimportable; the export reads back through safetensors (here) equal
    to the import's source (no layer scales, so nothing folds)."""
    import numpy as np
    from safetensors.numpy import load_file, save_file

    from multi_spatialmllm_tpu_torch.models import checkpoint_import as TC
    from multi_spatialmllm_tpu_torch.models import mllm as TMM

    cfg = TMM.tiny_config()
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                           vocab_size=800))
    state = TC.make_fixture_state_dict(cfg, 3, with_layer_scale=False)
    names = list(state)
    (tmp_path / "hf").mkdir()
    save_file({k: state[k] for k in names[:30]},
              str(tmp_path / "hf" / "model-1.safetensors"))
    save_file({k: state[k] for k in names[30:]},
              str(tmp_path / "hf" / "model-2.safetensors"))
    [imp] = _run_blocked(
        ["import-checkpoint", "--checkpoint", "hf", "--output", "m.pt",
         "--config", "tiny", "--vocab-size", "800", "--dtype", "float32",
         "--device", "cpu"], tmp_path, blocked=_CARD_BLOCKED)
    assert imp["parameters"] == sum(v.size for v in state.values())
    [exp] = _run_blocked(
        ["export-checkpoint", "--checkpoint", "m.pt", "--output", "out",
         "--config", "tiny", "--vocab-size", "800", "--dtype", "float32",
         "--shard-gb", "0.001", "--device", "cpu"], tmp_path,
        blocked=_CARD_BLOCKED)
    assert exp["shards"] > 1
    assert (tmp_path / "out" / "model.safetensors.index.json").exists()
    back = {}
    for f in sorted((tmp_path / "out").glob("*.safetensors")):
        back.update(load_file(str(f)))
    assert sorted(back) == sorted(state)
    for k, v in state.items():
        assert np.array_equal(back[k], v), k

    _write_mixture(tmp_path)
    [report] = _run_blocked(
        ["train", "--meta", "mix.json", "--config", "tiny", "--device",
         "cpu", "--vocab-size", "800", "--init-checkpoint", "m.pt",
         "--lora-rank", "2", "--steps", "3", "--batch-size", "2",
         "--seq-len", "128", "--max-tiles", "1", "--tiles-per-image", "1",
         "--warmup", "1", "--lr", "1e-3", "--output", "lora_ckpt"],
        tmp_path, blocked=_CARD_BLOCKED)
    assert report["steps"] == 3
    [served] = _run_blocked(["m.pt"], tmp_path, blocked=_CARD_BLOCKED,
                            body=_ADAPTER_SERVE)
    assert len(served["tokens"]) == 4
    assert all(0 < len(t) <= 4 for t in served["tokens"])


@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: k.name)
def test_kernel_build_without_cuda_raises(kernel, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        kernel.build()


def test_unsupported_device_raises_not_falls_back():
    q = torch.empty(1, 2, 128, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TA.flash_attention_fwd(q, q, q, True)
    lse = torch.empty(1, 2, 128, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TA.flash_attention_bwd(q, q, q, q, lse, q, True)
    qd = torch.empty(1, 2, 1, 32, device="meta")
    pool = torch.empty(4, 2, 16, 32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        TP.paged_decode_attention(qd, pool, pool,
                                  torch.empty(1, 2, device="meta"),
                                  torch.empty(1, device="meta"),
                                  torch.empty(1, 2, 32, device="meta"),
                                  torch.empty(1, 2, 32, device="meta"))


# the card's installation: what it lacks cannot be imported, and any
# attempt at jax or the JAX package is reported
_CARD_BLOCKED = BLOCKED + ("cv2", "pandas", "pyarrow")


def test_eval_and_serve_options_run_with_the_cards_installation(tmp_path):
    """`eval` (paged with every serving option and int8 weights; batched
    with option scoring) and `serve --sampling --logprobs` on JPEG and PNG
    frames, with cv2, jax and the JAX package unimportable."""
    import cv2
    import numpy as np
    import torch

    from multi_spatialmllm_tpu_torch.models import mllm as TMM

    rng = np.random.default_rng(2)
    (tmp_path / "imgs").mkdir()
    for i, ext in enumerate(("jpg", "png")):
        cv2.imwrite(str(tmp_path / "imgs" / f"f{i}.{ext}"),
                    rng.integers(0, 255, (96, 128, 3), dtype=np.uint8))
    cfg = TMM.tiny_config()
    model = TMM.MultiFrameMLLM(dataclasses.replace(
        cfg, llm=dataclasses.replace(cfg.llm, vocab_size=800)))
    TMM.init_random_weights(model, 0)
    torch.save(model.state_dict(), tmp_path / "tiny.pt")
    stem = "every distance in millimeters from the first camera center. "
    recs = [{"id": f"{i}-{q}", "image": [f"f{i}.{ext}"],
             "text": f"<image>\n{stem}Question {q}?",
             "question_type": "depth_estimation_coor", "gt_value": 900}
            for i, ext in enumerate(("jpg", "png")) for q in range(2)]
    recs.append({"id": "mc", "image": ["f0.jpg", "f1.png"],
                 "text": "<image>\n<image>\nWhich point? A B C D",
                 "question_type": "visual_correspondence_multiple_choice",
                 "gt_value": "A"})
    (tmp_path / "eval.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    common = ["--checkpoint", "tiny.pt", "--config", "tiny", "--device",
              "cpu", "--vocab-size", "800", "--images-root", "imgs",
              "--max-tiles", "1", "--max-new-tokens", "4"]
    paged = ["--paged", "--slots", "2", "--page-size", "16", "--num-pages",
             "64", "--max-prompt-len", "128"]
    [rep] = _run_blocked(
        ["eval", *common, "--eval-jsonl", "eval.jsonl", *paged,
         "--prefix-cache", "--prefill-chunk", "16", "--vision-cache", "2",
         "--speculate", "2", "--kv-dtype", "int8", "--quantize-weights"],
        tmp_path, blocked=_CARD_BLOCKED)
    assert rep["count"] == 5
    assert rep["serving_stats"]["vision_hits"] >= 2
    assert rep["serving_stats"]["prefill_resumed"] >= 1
    [rep] = _run_blocked(
        ["eval", *common, "--eval-jsonl", "eval.jsonl", "--batch-size", "2",
         "--mc-logprob", "--output", "out.json"], tmp_path,
        blocked=_CARD_BLOCKED)
    saved = json.loads((tmp_path / "out.json").read_text())
    assert saved["predictions"][-1] in "ABCD" and rep["count"] == 5
    lines = "".join(json.dumps({"id": f"q{i}", "image": [f"f{i}.{ext}"],
                                "text": "<image>\nhow far?",
                                "temperature": 0.8, "seed": i}) + "\n"
                    for i, ext in enumerate(("jpg", "png")))
    results = _run_blocked(
        ["serve", *common, *paged[1:], "--sampling", "--logprobs",
         "--prefix-cache"], tmp_path, stdin=lines, blocked=_CARD_BLOCKED)
    assert sorted(r["id"] for r in results) == ["q0", "q1"]
    assert all(len(r["logprobs"]) == len(r["token_ids"]) for r in results)


def _blocking(blocked):
    return textwrap.dedent(f"""
    import importlib.abc, importlib.machinery, json, sys

    tried = []

    class Refuse(importlib.abc.MetaPathFinder, importlib.abc.Loader):
        # as _blocker's, and each attempt is recorded
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in {blocked!r}:
                tried.append(top)
                return importlib.machinery.ModuleSpec(name, self)
            return None

        def create_module(self, spec):
            raise ImportError("No module named " + repr(spec.name))

        def exec_module(self, module):
            pass

    sys.meta_path.insert(0, Refuse())
    from multi_spatialmllm_tpu_torch.__main__ import main
    main(sys.argv[1:])
    print(json.dumps({{"tried": sorted(set(tried)), "loaded": sorted(
        m for m in sys.modules if m.split(".")[0] in {BLOCKED!r})}}))
""")



def _run_data_command(tmp_path, out, blocked, *args):
    """A port command in a subprocess with `blocked` unimportable; the
    string hash that seeds the synthetic frames is pinned, so two runs
    draw the same frames."""
    env = _env()
    env["PYTHONHASHSEED"] = "0"
    proc = subprocess.run(
        [sys.executable, "-c", _blocking(blocked), *args, "--output",
         str(out)],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.splitlines()[-1])


def _demo(tmp_path, name, blocked):
    """`demo --device cpu` at a tiny size."""
    out = tmp_path / name
    return out, _run_data_command(
        tmp_path, out, blocked, "demo", "--device", "cpu", "--scenes", "2",
        "--images-per-scene", "8", "--points-per-scene", "1500")


def _same_files(got_root, want_root):
    got = {p.relative_to(got_root): p.read_bytes()
           for p in got_root.rglob("*") if p.is_file()}
    want = {p.relative_to(want_root): p.read_bytes()
            for p in want_root.rglob("*") if p.is_file()}
    assert sorted(got) == sorted(want) and got
    for k, data in want.items():
        assert got[k] == data, k
    return got


def test_demo_runs_with_the_cards_installation(tmp_path):
    """`demo --device cpu` at a tiny size with jax, flax, optax, orbax,
    cv2, pandas, pyarrow and the JAX package unimportable: it finishes,
    writes the JSONL of every engine (the object-movement engines' on
    their TAPVid records too) and the annotated JPEGs, records that no
    relations parquet was written, never reaches for jax, the JAX package
    or cv2, and writes the JPEGs (and JSONL) of a run with cv2, pandas and
    pyarrow importable."""
    out, report = _demo(tmp_path, "card", _CARD_BLOCKED)
    bad = {"jax", "jaxlib", "flax", "optax", "orbax", "multi_spatialmllm_tpu",
           "cv2"}
    assert not bad & set(report["tried"]) and not report["loaded"], report
    qa = out / "qa"
    for split, name in (("training_data", "total_distance_train.jsonl"),
                        ("evaluation_data", "total_distance_val.jsonl")):
        lines = (qa / split / "camera_movement" / name).read_text()
        assert lines and all(json.loads(ln)["image"]
                             for ln in lines.splitlines())
    assert not (out / "indices" / "frame_relations.parquet").exists()
    rel = [json.loads(ln) for ln in (out / "manifest.jsonl").read_text()
           .splitlines() if '"frame_relations"' in ln]
    assert rel and rel[0]["outputs"]["parquet"] is None
    engines = {p.relative_to(qa).parts[1] for p in qa.rglob("*.jsonl")}
    assert len(engines) == 10 and {"object_movement_coord",
                                   "object_movement_dot"} <= engines, engines
    with_cv2, _ = _demo(tmp_path, "host", BLOCKED)
    got = _same_files(qa, with_cv2 / "qa")
    assert sum(str(k).endswith(".jpg") for k in got) > 50
    assert any("object_movement_dot" in str(k) and str(k).endswith(".jpg")
               for k in got)


def test_tapvid_runs_with_the_cards_installation(tmp_path):
    """`tapvid --device cpu --dot` over npz files made here, with the card's
    installation simulated: it never reaches for jax, the JAX package or
    cv2, and writes the files of a run with cv2 importable."""
    from multi_spatialmllm_tpu_torch.core.synthetic import make_tapvid_npz

    (tmp_path / "data" / "adt").mkdir(parents=True)
    (tmp_path / "meta" / "adt").mkdir(parents=True)
    for i in range(2):
        make_tapvid_npz(str(tmp_path / "data" / "adt" / f"c{i}.npz"),
                        seed=90 + i)
    (tmp_path / "meta" / "adt" / "train.txt").write_text("c0\nc1\n")
    args = ("tapvid", "--device", "cpu", "--dot", "--data",
            str(tmp_path / "data"), "--meta", str(tmp_path / "meta"))
    report = _run_data_command(tmp_path, tmp_path / "card", _CARD_BLOCKED,
                               *args)
    bad = {"jax", "jaxlib", "multi_spatialmllm_tpu", "cv2"}
    assert not bad & set(report["tried"]) and not report["loaded"], report
    _run_data_command(tmp_path, tmp_path / "host", BLOCKED, *args)
    got = _same_files(tmp_path / "card", tmp_path / "host")
    assert sum(str(k).endswith(".jsonl") for k in got) == 2
    assert any(str(k).endswith("_annotated.jpg") for k in got)


def test_ingest_coverage_pipeline_run_with_the_cards_installation(tmp_path):
    """`ingest-scannet`, `ingest-sens`, `coverage` (2 shards and
    `--merge`) and `pipeline --trace-dir` on the CPU over two scans written
    here, with the card's installation simulated: they never reach for
    jax, the JAX package or cv2, and write the files of the same commands
    run with cv2, pandas and pyarrow importable (the annotated frames are
    seeded by the string hash, pinned in both runs)."""
    from multi_spatialmllm_tpu_torch.core.synthetic import make_scene
    from multi_spatialmllm_tpu_torch.ingest.synthetic_scan import write_scan

    scans = tmp_path / "scans"
    for i in range(2):
        write_scan(str(scans), make_scene(
            scene_id=f"scene{i:04d}_00", seed=40 + i, n_images=6,
            n_background=1200, image_hw=(48, 64), depth_hw=(24, 32)),
            frame_skip=2)

    def commands(root):
        return [
            ["ingest-scannet", "--scans", str(scans), "--output",
             str(root / "exp")],
            ["ingest-sens", "--scans", str(scans), "--frame-skip", "2",
             "--output", str(root / "packs")],
            *[["coverage", "--scenes", str(root / "packs"), "--num-shards",
               "2", "--shard-index", str(i), "--output", str(root / "cov")]
              for i in range(2)],
            ["coverage", "--merge", "--output", str(root / "cov")],
            ["pipeline", "--scenes", str(root / "packs"), "--trace-dir",
             str(tmp_path / f"trace_{root.name}"), "--output",
             str(root / "run")]]

    bad = {"jax", "jaxlib", "multi_spatialmllm_tpu", "cv2"}
    card, host = tmp_path / "card", tmp_path / "host"
    for root, blocked in ((card, _CARD_BLOCKED), (host, BLOCKED)):
        for cmd in commands(root):
            report = _run_data_command(tmp_path, cmd[-1], blocked,
                                       *cmd[:-2], "--device", "cpu")
            assert not bad & set(report["tried"]) and not report["loaded"], \
                (cmd[0], report)
    for sub in ("exp", "packs", "cov"):
        _same_files(card / sub, host / sub)
    _same_files(card / "run" / "qa", host / "run" / "qa")
    assert len(os.listdir(tmp_path / "trace_card")) == 1


def _result_lines(stdout: str):
    return [ln for ln in stdout.splitlines() if '"ok"' in ln]


# the JAX dry run's 14 lines at 8 devices (__graft_entry__._dryrun_on_mesh
# and the data-engine lines)
DRYRUN_8 = [
    r"mesh=\(4 data x 2 model\), gloo/cpu, loss=\d+\.\d{4}$",
    r"tensor-parallel serving decode over the \(4 data x 2 model\) mesh ok$",
    r"paged serving \(prefix cache \+ chunked prefill \+ vision cache \+ "
    r"speculative\) under TP-sharded params ok, stats=\{.*\}$",
    r"paged multi-LoRA \+ sampled serving under TP-sharded params ok$",
    r"FULL-MLLM 1F1B \(8 stages x 4 microbatches, ViT\+projector preamble "
    r"\+ trainable head\), loss=\d+\.\d{4}$",
    r"combined \(data=2 x pipe=4\) MLLM 1F1B step, loss=\d+\.\d{4}$",
    r"combined \(data=2 x model=2 x pipe=2\) MLLM 1F1B step with "
    r"tensor-parallel stage bodies, loss=\d+\.\d{4}$",
    r"\(data=2 x model=2 x seq=2\) train step with ring attention, "
    r"loss=\d+\.\d{4}$",
    r"\(data=2 x expert=4\) MoE train step \(top-2 routed SwiGLU, "
    r"expert-sharded tables\), loss=\d+\.\d{4}$",
    r"ring attention over seq axis ok$",
    r"scene-parallel visibility over data axis ok \(8 scenes\)$",
    r"scene-parallel frame relations over data axis ok \(8 scenes, == "
    r"single-device\)$",
    r"scene-parallel object visibility over data axis ok "
    r"\(== single-device\)$",
    r"scene-parallel coverage intervals over data axis ok \(search results "
    r"== single-device\)$",
]


def test_dryrun_and_drill_run_with_the_cards_installation(tmp_path):
    """`python -m multi_spatialmllm_tpu_torch.dryrun 8 --device cpu` (eight
    gloo processes on the CPU) prints the JAX dry run's lines in its order
    on its meshes (every step's loss finite, every 1F1B gradient finite, the
    serving, ring and data-engine results checked in the ranks), and
    `scripts/torch_volume_drill.py --scale smoke --device cpu` (a killed
    and a resumed campaign process) runs, with jax, the JAX package and
    cv2 unimportable in every process they start: a `sitecustomize` on the
    path installs the refusing finder, so the children refuse too. pandas
    and pyarrow stay, as on the card: without them the relation table has
    no file to resume from, and the resumed campaign computes it again."""
    import re

    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        _blocker(BLOCKED + ("cv2",), body=""))
    env = dict(_env(), PYTHONPATH=os.pathsep.join([str(site), REPO]))
    refused = subprocess.run([sys.executable, "-c", "import jax"], env=env,
                             capture_output=True, text=True, timeout=60)
    assert refused.returncode != 0 and "blocked: jax" in refused.stderr
    proc = subprocess.run(
        [sys.executable, "-m", "multi_spatialmllm_tpu_torch.dryrun", "8",
         "--device", "cpu"], env=env,
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert len(lines) == len(DRYRUN_8), lines
    for line, pattern in zip(lines, DRYRUN_8):
        assert re.match(r"dryrun_multichip\(8\): " + pattern, line), line
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts",
                                      "torch_volume_drill.py"),
         "--scale", "smoke", "--device", "cpu", "--root",
         str(tmp_path / "drill")], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    report = json.loads((tmp_path / "drill" /
                         "torch_volume_drill.json").read_text())
    assert report["killed_mid_run"] and report["units_rerun"] == 0
    assert report["records"] > 0 and report["images"] > 0


def test_chip_smoke_refuses_without_cuda():
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=_env(), capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert not _result_lines(proc.stdout)


def test_chip_smoke_refuses_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = _env()
    env["PYTHONPATH"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert not _result_lines(proc.stdout)


def test_cuda_wrappers_check_operands_before_launch():
    """The CUDA wrappers refuse what the kernels do not take before any
    build or launch (shape/dtype checks run first)."""
    q = torch.zeros(1, 2, 64, 48)                      # head dim 48
    with pytest.raises(ValueError, match="head dim"):
        TA.flash_attention_fwd_cuda(q, q, q, True)
    lse = torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="head dim"):
        TA.flash_attention_bwd_cuda(q, q, q, q, lse, q, True)
    q16 = torch.zeros(1, 2, 64, 32, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        TA.flash_attention_fwd_cuda(q16, q16, q16, True)
    with pytest.raises(ValueError, match="dtype"):
        TA.flash_attention_bwd_cuda(q16, q16, q16, q16, lse, q16, True)
    q32 = torch.zeros(1, 2, 64, 32)
    with pytest.raises(ValueError, match="lse"):
        TA.flash_attention_bwd_cuda(q32, q32, q32, q32, lse[:, :1], q32,
                                    True)
    qd = torch.zeros(2, 4, 1, 32)
    pool = torch.zeros(5, 2, 16, 32)
    with pytest.raises(ValueError, match="page_table"):
        TP.paged_decode_attention_cuda(
            qd, pool, pool, torch.zeros(2, 3, dtype=torch.int64),
            torch.zeros(2, dtype=torch.int32), torch.zeros(2, 2, 32),
            torch.zeros(2, 2, 32))
    assert all(k.launches == 0 for k in KERNELS)


def test_library_path_follows_the_shared_headers(tmp_path):
    """The build cache is keyed on the source and every `csrc/*.cuh`: an
    edit to a header names a new library (no stale build loads), a file
    that is neither leaves the name alone."""
    csrc = tmp_path / "csrc"
    shutil.copytree(TB.CSRC_DIR, csrc)
    assert TB.library_path("flash_fwd", str(csrc)) == TB.library_path(
        "flash_fwd")
    before = TB.library_path("flash_fwd", str(csrc))
    (csrc / "notes.txt").write_text("not a header")
    assert TB.library_path("flash_fwd", str(csrc)) == before
    header = csrc / "hopper.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    after = TB.library_path("flash_fwd", str(csrc))
    assert after != before
    assert os.path.basename(after).startswith("libflash_fwd-")
    # every source that could include it is renamed too
    assert TB.library_path("flash_bwd", str(csrc)) != TB.library_path(
        "flash_bwd")


def test_misaligned_operand_raises_before_launch():
    """TMA needs 16-byte-aligned operands: the alignment helper refuses a
    contiguous view at an odd offset, and the forward and backward
    wrappers raise on one before any build or launch (no fallback)."""
    n = 2 * 4 * 128 * 64
    buf = torch.zeros(n + 8, dtype=torch.bfloat16)
    good = buf[:n].view(2, 4, 128, 64)
    bad = buf[1:n + 1].view(2, 4, 128, 64)      # 2 bytes past a boundary
    assert bad.is_contiguous() and bad.data_ptr() % 16 == 2
    TB.check_tma_aligned("q", good)
    with pytest.raises(ValueError, match="16-byte"):
        TB.check_tma_aligned("q", bad)
    before = TA.FLASH_FWD.launches
    for args in ((bad, good, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            TA.flash_attention_fwd_cuda(*args, True)
    assert TA.FLASH_FWD.launches == before
    # the backward wrapper: a misaligned q, k, v or dO
    lse = torch.zeros(2, 4, 128)
    bwd = (TA.FLASH_BWD_DQ.launches, TA.FLASH_BWD_DKV.launches)
    for at in (0, 1, 2, 5):   # q, k, v, dO in (q, k, v, o, lse, do)
        args = [good, good, good, good, lse, good]
        args[at] = bad
        with pytest.raises(ValueError, match="16-byte"):
            TA.flash_attention_bwd_cuda(*args, True)
    assert (TA.FLASH_BWD_DQ.launches, TA.FLASH_BWD_DKV.launches) == bwd
