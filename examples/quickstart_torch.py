"""Quickstart: the STC compression operator in 60 seconds (PyTorch port).

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

The twin of ``examples/quickstart.py`` on ``repro_torch``.  Runs on the
CUDA card unless ``--device cpu`` is given; the update is drawn from a
seeded ``torch.Generator``.
"""

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.core import (Codec, decode_ternary, decode_ternary_words,
                              encode_ternary, encode_ternary_words,
                              golomb_position_bits, make_protocol,
                              register_protocol, registered_protocols,
                              stc_compress, stc_message_bits)
from repro_torch.device import resolve_device


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = resolve_device(ap.parse_args().device)

    # --- 1. compress a "weight update" with Sparse Ternary Compression ------
    gen = torch.Generator().manual_seed(0)
    update = torch.randn(100_000, generator=gen).to(device)
    p = 1 / 400

    tern, stats = stc_compress(update, p)
    print(f"STC @ p=1/400: kept {int(stats.nnz)} / {update.numel()} "
          f"entries, µ = {float(stats.mu):.4f}")
    print(f"unique values: {np.unique(tern.cpu().numpy())[:5]}")

    # --- 2. what does it cost on the wire? (Golomb positions + sign bits) ---
    bits = stc_message_bits(update.numel(), p)
    print(f"message size: {bits/8/1024:.2f} KiB "
          f"(dense fp32 would be {update.numel()*4/1024:.0f} KiB -> "
          f"x{update.numel()*32/bits:.0f} compression)")
    print(f"bits per position (Eq. 17): {golomb_position_bits(p):.2f}")

    # --- 3. the real bitstream (Algorithms 3 & 4), roundtripped --------------
    host = tern.cpu().numpy()
    msg = encode_ternary_words(host, p)
    restored = decode_ternary_words(msg, p)
    assert np.allclose(restored, host, atol=1e-6)
    # ... bit-identical to the per-bit oracle codec (Algorithm 3)
    payload, bit_len, mu, n = encode_ternary(host, p)
    assert msg.bit_len == bit_len
    assert np.array_equal(msg.payload_bytes(), payload)
    assert np.allclose(decode_ternary(payload, bit_len, mu, n, p), restored)
    analytic = stc_message_bits(update.numel(), p) - 32
    print(f"bitstream: {msg.bit_len} bits measured "
          f"(analytic expectation {analytic:.0f}), roundtrip exact: True")

    # --- 4. error feedback: nothing is ever lost -----------------------------
    proto = make_protocol("stc", sparsity_up=p, sparsity_down=p)
    state = proto.init_client_state(update.numel(), device)
    msg, state, _ = proto.encode(update, state)
    recon = msg + state.residual
    assert torch.allclose(recon, update, rtol=1e-5)
    print("error feedback: msg + residual == update (exact)")

    # --- 5. protocols are pluggable codecs: register your own ---------------
    @register_protocol
    @dataclasses.dataclass(frozen=True)
    class RoundToHalf(Codec):
        """Toy codec: snap every coordinate to a multiple of `step`."""
        name = "round0.5"
        step: float = 0.5

        def encode(self, delta, state):
            msg = self.step * torch.round(delta / self.step)
            return msg, state, None

        def upload_bits(self, numel):
            return 8.0 * numel                   # one int8 symbol per weight

        def download_bits(self, numel, n_participating=1):
            return 8.0 * numel

    toy = make_protocol("round0.5")
    msg, _, _ = toy.encode(update, None)
    print(f"registered codecs: {registered_protocols()}")
    print(f"custom codec kept {len(torch.unique(msg))} distinct values "
          f"at {toy.upload_bits(update.numel())/8/1024:.0f} KiB/message")


if __name__ == "__main__":
    main()
