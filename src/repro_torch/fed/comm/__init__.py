"""Bidirectional compressed communication plane (see ``codecs.py``)."""
from .codecs import (CODECS, DIRECTIONS, DOWNLINK_STATE_KEY, UPLINK_STATE_KEY, Codec,
                     CodecEntry, build_codec, dense_bits, downlink_apply, downlink_round_keys,
                     make_identity, make_qsgd, make_randk, make_topk_raw, mbytes_per_slot,
                     register_codec, round_keys, tree_roundtrip, uplink_apply,
                     validate_codec_knobs, wire_bits_total, with_diana_shift,
                     with_error_feedback)

__all__ = ["CODECS", "DIRECTIONS", "DOWNLINK_STATE_KEY", "UPLINK_STATE_KEY", "Codec",
           "CodecEntry", "build_codec", "dense_bits", "downlink_apply", "downlink_round_keys",
           "make_identity", "make_qsgd", "make_randk", "make_topk_raw", "mbytes_per_slot",
           "register_codec", "round_keys", "tree_roundtrip", "uplink_apply",
           "validate_codec_knobs", "wire_bits_total", "with_diana_shift",
           "with_error_feedback"]
