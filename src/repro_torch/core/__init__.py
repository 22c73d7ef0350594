"""Compression operators, codecs and the wire format (see each module).

The public surface of the reference's ``core`` package, in PyTorch, minus
the mesh path's names (still to port).
"""

from .adaptive import (FixedController, ResidualMassController,
                       SnrConstantController, SparsityController,
                       make_controller, register_controller,
                       registered_controllers, validate_sparsity)
from .aggregation import (AggregationRule, CoordinateMedianRule, MeanRule,
                          NormScreenedMeanRule, TrimmedMeanRule,
                          get_rule_class, make_rule, register_rule,
                          registered_rules)
from .caching import UpdateCache
from .chunking import (ChunkedCodec, ChunkSpec, chunk_codec,
                       chunk_spec_from_sizes, chunk_spec_from_tree,
                       whole_vector_spec)
from .compression import (CompressionStats, StcBackend, flatten_pytree,
                          get_stc_backend, majority_vote_sign,
                          register_stc_backend, select_batch_dynamic,
                          sign_compress, stc_compress, stc_compress_blocks,
                          stc_compress_pytree, ternarize, ternary_quantize,
                          top_k_mask, top_k_sparsify, unflatten_pytree)
from .golomb import (decode_ternary, encode_ternary, entropy_sparse,
                     entropy_sparse_ternary, golomb_b_star,
                     golomb_position_bits, stc_message_bits,
                     stc_stream_bound_bits, ternary_dense_bits)
from .ingest import IngestAccumulator
from .protocols import (PROTOCOLS, BaselineCodec, Codec, FedAvgCodec,
                        Protocol, SignSGDCodec, StcCodec, TernQuantCodec,
                        TopKCodec, get_protocol_class, make_protocol,
                        register_protocol, registered_protocols)
from .residual import (ResidualState, compress_with_feedback, init_residual,
                       scatter_states, stack_states, take_states)
from .wire import (WireBatch, WireDecodeError, WireMessage,
                   decode_ternary_fields, decode_ternary_fields_batch,
                   decode_ternary_words, decode_ternary_words_batch,
                   encode_ternary_words, encode_ternary_words_batch,
                   get_wire_backend, pack_sign_words, register_wire_backend,
                   sign_plane_bits, unpack_sign_words)

__all__ = [
    "CompressionStats", "StcBackend", "get_stc_backend",
    "register_stc_backend", "flatten_pytree", "majority_vote_sign",
    "sign_compress", "stc_compress", "stc_compress_blocks",
    "stc_compress_pytree", "ternarize", "ternary_quantize", "top_k_mask",
    "top_k_sparsify", "unflatten_pytree", "select_batch_dynamic",
    "decode_ternary", "encode_ternary", "entropy_sparse",
    "entropy_sparse_ternary", "golomb_b_star", "golomb_position_bits",
    "stc_message_bits", "stc_stream_bound_bits", "ternary_dense_bits",
    "WireMessage", "WireBatch", "WireDecodeError", "encode_ternary_words",
    "encode_ternary_words_batch", "decode_ternary_words",
    "decode_ternary_words_batch", "decode_ternary_fields",
    "decode_ternary_fields_batch", "pack_sign_words", "unpack_sign_words",
    "sign_plane_bits", "get_wire_backend", "register_wire_backend",
    "IngestAccumulator",
    "AggregationRule", "MeanRule", "NormScreenedMeanRule",
    "CoordinateMedianRule", "TrimmedMeanRule", "make_rule", "register_rule",
    "registered_rules", "get_rule_class",
    "PROTOCOLS", "Codec", "Protocol", "make_protocol", "register_protocol",
    "registered_protocols", "get_protocol_class", "BaselineCodec",
    "FedAvgCodec", "SignSGDCodec", "TopKCodec", "StcCodec", "TernQuantCodec",
    "SparsityController", "FixedController", "ResidualMassController",
    "SnrConstantController", "make_controller", "register_controller",
    "registered_controllers", "validate_sparsity",
    "ChunkSpec", "ChunkedCodec", "chunk_codec", "chunk_spec_from_sizes",
    "chunk_spec_from_tree", "whole_vector_spec",
    "ResidualState", "compress_with_feedback", "init_residual",
    "stack_states", "take_states", "scatter_states",
    "UpdateCache",
]
