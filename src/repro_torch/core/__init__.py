"""Compression operators, codecs and the wire format (see each module)."""

from .aggregation import AggregationRule, MeanRule, make_rule
from .compression import (CompressionStats, flatten_pytree, get_stc_backend,
                          stc_compress, unflatten_pytree)
from .ingest import IngestAccumulator
from .protocols import (Codec, SignSGDCodec, StcCodec, make_protocol,
                        register_protocol, registered_protocols)
from .residual import ResidualState, init_residual

__all__ = ["AggregationRule", "MeanRule", "make_rule", "CompressionStats",
           "flatten_pytree", "unflatten_pytree", "get_stc_backend",
           "stc_compress", "IngestAccumulator", "Codec", "StcCodec",
           "SignSGDCodec", "make_protocol",
           "register_protocol", "registered_protocols", "ResidualState",
           "init_residual"]
