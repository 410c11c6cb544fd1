"""The traffic generator, the tokenizer and the frames repeat for a seed,
and the reference's input path agrees with the program's."""

import itertools
import os

import numpy as np

from bench_port import frames, mix
from bench_port.reference import data as RD

BANK = mix.load_bank("multispa_bank")


def take(seed, n=40, stream=0, budgets=(8, 16, 24, 32, 40, 48, 56, 64)):
    names = [f"frame_{i:03d}.jpg" for i in range(16)]
    return list(itertools.islice(
        mix.records(BANK, seed, names, stream, list(budgets)), n))


def test_records_repeat_for_a_seed():
    assert take(2 ** 31 + 11) == take(2 ** 31 + 11)
    assert take(2 ** 31 + 11) != take(2 ** 31 + 12)
    assert take(5, stream=0) != take(5, stream=1)


def test_every_seed_serves_the_same_mix():
    """Engines come in rounds of one each, budgets in rounds of all."""
    for seed in (0, 7, 2 ** 33 + 5):
        recs = take(seed, n=40)
        for r in range(8):
            assert sorted(x["engine"] for x in recs[5 * r:5 * r + 5]) == \
                sorted(BANK)
        for r in range(5):
            assert sorted(x["max_new_tokens"] for x in
                          recs[8 * r:8 * r + 8]) == list(range(8, 65, 8))
        for x in recs:
            frames_of = {b["human"]: b["frames"] for b in BANK[x["engine"]]}
            assert len(x["image"]) == frames_of[
                x["conversations"][0]["value"]]


def test_tokenizer_round_trip_and_specials():
    from multi_spatialmllm_tpu_torch.models import tokenizer as program_tok

    tok = mix.tokenizer(BANK)
    assert tok.img_context_id == 3
    for s in (program_tok.HUMAN, program_tok.ASSISTANT, program_tok.IMG_START,
              program_tok.IMG_END, program_tok.IMG_CONTEXT):
        assert len(tok.encode(s)) == 1
    text = BANK["camera_movement"][0]["human"] + " ünïcode 123"
    assert tok.decode(tok.encode(text)) == text
    assert tok.decode([tok.vocab_size + 5]) == f"<t{tok.vocab_size + 5}>"
    assert tok.vocab_size < 1024


def test_frames_read_back_by_both_readers(tmp_path):
    from multi_spatialmllm_tpu_torch.__main__ import _read_image

    names = frames.write_pool(str(tmp_path), 2 ** 32 + 3, 2)
    (tmp_path / "b").mkdir()
    again = frames.write_pool(str(tmp_path / "b"), 2 ** 32 + 3, 1)
    for n in names:
        path = os.path.join(tmp_path, n)
        ref = frames.read_jpeg(path)
        assert ref.shape == frames.SCANNET_HW + (3,)
        np.testing.assert_array_equal(_read_image(path), ref)
    with open(os.path.join(tmp_path, names[0]), "rb") as f, \
            open(os.path.join(tmp_path / "b", again[0]), "rb") as g:
        assert f.read() == g.read()


def test_reference_tiles_within_two_levels_of_the_program():
    """The reference resizes by exact area weights in float64; the
    program reproduces cv2's fixed-point INTER_AREA. They differ by at
    most two levels of 255, on a share of the values."""
    from multi_spatialmllm_tpu_torch.models.preprocess import (
        PreprocessConfig,
        tile_image,
    )

    img = frames.make_frame(np.random.default_rng(9))
    ref = RD.tile(img, 6, 448)
    prog = tile_image(img, PreprocessConfig(448, 6, True, None))
    assert ref.shape == prog.shape == (7, 448, 448, 3)
    levels = np.abs(ref - prog) * np.asarray([0.229, 0.224, 0.225]) * 255
    assert levels.max() < 2.05
    assert (levels > 0.5).mean() < 0.2
