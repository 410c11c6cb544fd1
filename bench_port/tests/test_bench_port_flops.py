"""The corrected FLOP count against a count by hand at a tiny size."""

import pytest

from bench_port import flops, model

from .tiny import TINY


@pytest.fixture
def d():
    cfg = model.load_config("internvl2_2b")
    for k, patch in TINY.items():
        cfg[k] = {**cfg[k], **patch}
    return model.dims(cfg)


# One real tile (grid 4: 17 ViT tokens, 4 projected), segments of 10 and 6.
# ViT: per token a layer qkv 3*64*64 + proj 64*64 + fc1 64*128 + fc2 128*64
# = 32,768 weights: 2 * 17 * 2 * 32,768 = 2,228,224; the patch conv
# 2 * 17 * 3 * 196 * 64 = 1,279,488; attention 2 layers * 4 * 64 * 17^2
# = 147,968. Projector: 2 * 4 * (256 * 64 + 64 * 64) = 163,840. LLM: wq, wo
# 64*64 each, wk, wv 64*32 each, gate/up/down 3 * 64 * 128: 36,864 a layer,
# 2 layers + lm_head 64 * 1024 = 139,264 weights, 2 * 16 tokens * 139,264 =
# 4,456,448; attention 2 * 4 * 4 heads * 16 * (55 + 21 pairs) = 38,912.
VISION = 2_228_224 + 1_279_488 + 147_968
PROJECTOR = 163_840
LLM = 4_456_448 + 38_912


def test_forward_by_part(d):
    assert flops.forward_flops(d, [10, 6], 1) == {
        "vision": VISION, "projector": PROJECTOR, "llm": LLM}


@pytest.mark.parametrize("trained, expect", [
    # every part trains: 3x
    (("vision", "projector", "llm"), 3 * (VISION + PROJECTOR + LLM)),
    # a frozen tower no gradient enters: 1x
    (("projector", "llm"), VISION + 3 * (PROJECTOR + LLM)),
    # the frozen LLM passes the projector's gradient through: 2x
    (("projector",), VISION + 3 * PROJECTOR + 2 * LLM),
    # nothing trains: the forward alone
    ((), VISION + PROJECTOR + LLM),
])
def test_train_flops_by_what_trains(d, trained, expect):
    assert flops.train_flops(d, [10, 6], 1, trained) == expect


def test_attention_and_decode_counts(d):
    assert flops.train_attn_flops(d, [10, 6], 1) == 3 * (38_912 + 147_968)
    assert flops.prefill_flops(d, 16, 1) == (
        VISION + PROJECTOR + 4_456_448 + 2 * 4 * 64 * (16 * 17 // 2))
    # position 9 attends to 10 keys
    assert flops.decode_flops(d, 9) == 2 * 139_264 + 2 * 4 * 64 * 10
    # 2 layers: (9 + 2) kv rows of 2 * 2 heads * 16 * 2 bytes, q and o
    assert flops.decode_kv_bytes(d, 9) == 2 * (11 * 128 + 2 * 64 * 2)
