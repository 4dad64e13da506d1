"""The frozen counts against the figures the repo's records give."""

import json
import os

from benchmark import roofline

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")
MISTRAL = dict(vocab=32000, d_model=4096, n_layers=2, n_heads=32, n_kv_heads=8, d_ff=14336)


def test_window_reduction_bytes_match_chip_smoke():
    assert roofline.window_reduction_bytes(4096, 64, 32) == 36_700_160
    assert roofline.window_reduction_bytes(4096, 64, 512) == 540_016_640


def test_window_reduction_bound_is_the_recorded_one():
    assert round(roofline.window_reduction_bound_s(4096, 64, 512) * 1e3, 4) == 0.1612


def test_mistral_parameter_counts():
    p = roofline.decoder_parameters(**MISTRAL)
    assert p["per_layer"] == 218_112_000
    assert p["embedding"] == p["head"] == 131_072_000
    assert p["non_embedding"] == 567_300_096
    assert p["total"] == 698_372_096


def test_mistral_flop_per_token_at_4096():
    assert round(roofline.train_flop_per_token(**MISTRAL, seq=4096) / 1e9, 3) == 3.605


def test_config_file_states_the_counts_it_runs():
    with open(os.path.join(CONFIGS, "mistral-7b-l2.json")) as f:
        cfg = json.load(f)
    p = roofline.decoder_parameters(
        cfg["vocab_size"], cfg["hidden_size"], cfg["num_hidden_layers"],
        cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["intermediate_size"])
    assert p == cfg["parameters"]


def test_shares_are_none_without_a_measurement():
    assert roofline.share_percent(1.0, 0.0) is None
    assert roofline.share_percent(1.0, 4.0) == 25.0
