"""Hand-written Hopper kernels for the STC hot path, with their plain
PyTorch versions.

* ``stc_compress``   -- fused mask -> ternarize -> error feedback
  (``csrc/stc_apply.cu``).
* ``hist_select``    -- per-row 256-bin magnitude histogram
  (``csrc/histogram.cu``), the exact select inside the candidate bin
  (``csrc/bin_select.cu``) and the k-selection they make up.
* ``topk_threshold`` -- threshold statistics (``csrc/threshold_stats.cu``)
  and the bisection k-selection (``selector="bisect"``), one launch of a
  thread block cluster on the card (``csrc/bisect_select.cu``).
* ``bitpack``        -- MSB-first word packing of the wire stream: Golomb
  chunks (``csrc/pack_chunks.cu``), the device half of the ``"kernel"``
  ternary wire encode, and batches of bit planes and of signSGD's fp32
  sign planes, one launch a batch (``csrc/pack_bits.cu``).
* ``wiredecode``     -- the ternary wire's Golomb field decode
  (``csrc/golomb_decode.cu``), the ``"kernel"`` backend's ternary decode,
  word unpacking with zero counts (``csrc/unpack_bits.cu``), its
  sign-plane decode, and the signSGD ingest's sign-plane tally into the
  accumulator (the same source).
* ``ops``            -- STC with error feedback composed from the above.
* ``ref``            -- the reference's oracles in plain PyTorch
  (``stc_compress_ref``, ``pack_bits_ref``, ``unpack_bits_ref`` here).

The reference's names stand beside the batched ones: the one-row
``stc_apply``, ``magnitude_histogram`` and ``hist_topk_threshold`` (a
batch of one row), ``pack_bits_words`` (``pack_bits``) and
``pack_bits_words_batched`` (``pack_bits_batched``), and ``PASSES``.  Its
``resolve_interpret`` has none: a wrapper picks its kernel or its plain
version from the tensor's device.

Each wrapper launches its CUDA kernel on a CUDA tensor (raising if the
build or the launch fails) and runs its plain version on a CPU tensor.
``LAUNCHES`` counts the kernel launches.  The kernels are built on first use
(see ``_build``), never when a module is imported.
"""

from ..core.selection import PASSES
from ._build import LAUNCHES, build_all
from .bitpack import (pack_bits, pack_bits_batched, pack_bits_batched_plain,
                      pack_bits_plain, pack_bits_words,
                      pack_bits_words_batched, pack_chunks,
                      pack_chunks_plain, pack_sign_planes,
                      pack_sign_planes_plain)
from .hist_select import (candidate_select_batched, candidate_select_plain,
                          hist_topk_threshold, hist_topk_threshold_batched,
                          magnitude_histogram, magnitude_histogram_batched,
                          magnitude_histogram_plain)
from .ops import stc_compress_batch, stc_compress_kernel, stc_compress_rows
from .ref import pack_bits_ref, stc_compress_ref, unpack_bits_ref
from .stc_compress import stc_apply, stc_apply_batched, stc_apply_plain
from .topk_threshold import (threshold_stats, threshold_stats_plain,
                             topk_threshold, topk_threshold_plain)
from .wiredecode import (decode_golomb_fields, decode_golomb_fields_plain,
                         sign_plane_tally, sign_plane_tally_plain,
                         unpack_bits_words, unpack_words_batched,
                         unpack_words_plain, unpack_words_with_counts)

__all__ = [
    "LAUNCHES",
    "PASSES",
    "build_all",
    "stc_compress_rows",
    "stc_compress_batch",
    "stc_compress_kernel",
    "stc_compress_ref",
    "hist_topk_threshold",
    "hist_topk_threshold_batched",
    "magnitude_histogram",
    "magnitude_histogram_batched",
    "magnitude_histogram_plain",
    "candidate_select_batched",
    "candidate_select_plain",
    "stc_apply",
    "stc_apply_batched",
    "stc_apply_plain",
    "threshold_stats",
    "threshold_stats_plain",
    "topk_threshold",
    "topk_threshold_plain",
    "pack_bits",
    "pack_bits_plain",
    "pack_bits_batched",
    "pack_bits_batched_plain",
    "pack_bits_words",
    "pack_bits_words_batched",
    "pack_bits_ref",
    "pack_sign_planes",
    "pack_sign_planes_plain",
    "pack_chunks",
    "pack_chunks_plain",
    "unpack_words_batched",
    "unpack_words_with_counts",
    "unpack_bits_words",
    "unpack_words_plain",
    "unpack_bits_ref",
    "sign_plane_tally",
    "sign_plane_tally_plain",
    "decode_golomb_fields",
    "decode_golomb_fields_plain",
]
