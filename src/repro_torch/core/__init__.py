"""Compression operators, codecs and the wire format (see each module)."""

from .adaptive import (FixedController, ResidualMassController,
                       SnrConstantController, SparsityController,
                       make_controller, register_controller,
                       registered_controllers, validate_sparsity)
from .aggregation import AggregationRule, MeanRule, make_rule
from .chunking import (ChunkedCodec, ChunkSpec, chunk_codec,
                       chunk_spec_from_sizes, chunk_spec_from_tree,
                       whole_vector_spec)
from .compression import (CompressionStats, flatten_pytree, get_stc_backend,
                          select_batch_dynamic, stc_compress,
                          stc_compress_blocks, ternary_quantize,
                          top_k_sparsify, unflatten_pytree)
from .ingest import IngestAccumulator
from .protocols import (BaselineCodec, Codec, FedAvgCodec, SignSGDCodec,
                        StcCodec, TernQuantCodec, TopKCodec, make_protocol,
                        register_protocol, registered_protocols)
from .residual import ResidualState, compress_with_feedback, init_residual

__all__ = ["AggregationRule", "MeanRule", "make_rule", "CompressionStats",
           "flatten_pytree", "unflatten_pytree", "get_stc_backend",
           "stc_compress", "top_k_sparsify", "ternary_quantize",
           "IngestAccumulator", "Codec", "BaselineCodec", "FedAvgCodec",
           "SignSGDCodec", "TopKCodec", "StcCodec", "TernQuantCodec",
           "make_protocol", "register_protocol", "registered_protocols",
           "ResidualState", "init_residual", "compress_with_feedback",
           "select_batch_dynamic", "stc_compress_blocks", "ChunkSpec",
           "ChunkedCodec", "chunk_codec", "chunk_spec_from_sizes",
           "chunk_spec_from_tree", "whole_vector_spec", "SparsityController",
           "FixedController", "ResidualMassController",
           "SnrConstantController", "make_controller", "register_controller",
           "registered_controllers", "validate_sparsity"]
