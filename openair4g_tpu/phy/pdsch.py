"""DLSCH transport-channel processing: the full 36.212 §5.3.2 bit chain.

Reference parity:
  - TX: openair1/PHY/LTE_TRANSPORT/dlsch_coding.c:254 (dlsch_encoding:
    CRC24A -> segmentation -> turbo encode -> rate matching -> concat)
  - RX: dlsch_decoding.c:164 (rate-dematch + HARQ soft combine -> turbo
    decode with CRC early stop -> TB reassembly)

Everything is batched over the leading trial/UE axis; the
per-code-block structure (C, K+/K-, E_r, filler) is static per configuration,
so the block loop unrolls at trace time and blocks of equal K decode as one
stacked call into the windowed turbo decoder.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax.numpy as jnp

from ..tables.tbs import get_TBS_DL, get_Qm, get_G_dl
from ..ops.segmentation import segment_tb, Segmentation
from ..ops import turbo
from ..ops.crc import crc_device, crc_matrix
from ..ops.rate_match import (make_rate_match_maps, compute_ncb, block_e_sizes,
                              rate_match_tx, rate_match_rx, w_to_d_llr,
                              RateMatchMaps)


@dataclass(frozen=True)
class DlschConfig:
    mcs: int
    n_rb: int
    n_pdcch_symbols: int = 1
    rv: int = 0
    n_turbo_iter: int = 8
    decoder_window: int | None = None   # None: ops/decoder_settings.py
    decoder_warmup: int | None = None
    nports: int = 1            # TX antenna ports (2 => SFBC, 8 RE/RB pilots)
    g_override: int | None = None   # custom RE budget (PMCH/MBSFN region)

    @property
    def tbs(self) -> int:
        return get_TBS_DL(self.mcs, self.n_rb)

    @property
    def Qm(self) -> int:
        return get_Qm(self.mcs)

    @property
    def G(self) -> int:
        if self.g_override is not None:
            return self.g_override
        return get_G_dl(self.n_rb, self.Qm, self.n_pdcch_symbols,
                        siso=self.nports == 1)


class DlschCodec:
    """Static-plan encoder/decoder for one DLSCH configuration."""

    def __init__(self, cfg: DlschConfig):
        self.cfg = cfg
        self.seg: Segmentation = segment_tb(cfg.tbs + 24)
        seg = self.seg
        self.block_Ks = list(seg.block_sizes)
        C = seg.C
        self.Es = block_e_sizes(cfg.G, C, cfg.Qm)
        # Static maps per (redundancy version, block); Ncb depends on K.
        self.maps_by_rv: dict[int, list[RateMatchMaps]] = {}
        for rv in range(4):
            self.maps_by_rv[rv] = [
                make_rate_match_maps(K, seg.F if r == 0 else 0, rv,
                                     self.Es[r], compute_ncb(K, C))
                for r, K in enumerate(self.block_Ks)]
        self.maps = self.maps_by_rv[cfg.rv]
        # payload (data) bits contributed by each block to the TB stream
        self.block_payload = []
        for r, K in enumerate(self.block_Ks):
            L = 24 if C > 1 else 0
            F = seg.F if r == 0 else 0
            self.block_payload.append(K - L - F)
        assert sum(self.block_payload) == cfg.tbs + 24, \
            (sum(self.block_payload), cfg.tbs)

    # ------------------------------------------------------------------ TX --
    def encode_to_d(self, tb_bits):
        """tb_bits [B, TBS] -> list of per-block d_flat [B, 3*(K+4)].

        The turbo-coded streams are rv-independent; HARQ retransmissions
        reuse them with a different rate-matching selection (the reference
        re-encodes only on round 0, dlsch_coding.c:286).
        """
        cfg, seg = self.cfg, self.seg
        B = tb_bits.shape[0]
        crc_a = jnp.round(crc_device(tb_bits, "crc24a")).astype(jnp.int32)
        b = jnp.concatenate([tb_bits, crc_a], axis=1)      # [B, TBS+24]

        blocks = []
        pos = 0
        for r, K in enumerate(self.block_Ks):
            n = self.block_payload[r]
            data = b[:, pos:pos + n]
            pos += n
            if r == 0 and seg.F:
                data = jnp.concatenate(
                    [jnp.zeros((B, seg.F), jnp.int32), data], axis=1)
            if seg.C > 1:
                crc_b = jnp.round(crc_device(data, "crc24b")).astype(jnp.int32)
                data = jnp.concatenate([data, crc_b], axis=1)
            assert data.shape[1] == K
            blocks.append(data)

        # turbo-encode blocks grouped by K (single batched call per size)
        d_by_block = self._encode_blocks(blocks)
        return [d.reshape(B, -1) for d in d_by_block]      # [B, 3*(K+4)] each

    def select_e(self, d_flats, rv: int | None = None):
        """Rate-match the encoded streams for one redundancy version."""
        maps = self.maps_by_rv[self.cfg.rv if rv is None else rv]
        return jnp.concatenate(
            [rate_match_tx(d, maps[r]) for r, d in enumerate(d_flats)], axis=1)

    def encode(self, tb_bits, rv: int | None = None):
        """tb_bits [B, TBS] int32 {0,1} -> e [B, G] int32."""
        return self.select_e(self.encode_to_d(tb_bits), rv)

    def _encode_blocks(self, blocks):
        by_k = {}
        for r, blk in enumerate(blocks):
            by_k.setdefault(blk.shape[1], []).append((r, blk))
        out = [None] * len(blocks)
        for K, items in by_k.items():
            stacked = jnp.concatenate([blk for _, blk in items], axis=0)
            d = turbo.turbo_encode_device(stacked, turbo.qpp_interleaver(K))
            B = blocks[0].shape[0]
            for i, (r, _) in enumerate(items):
                out[r] = d[i * B:(i + 1) * B]
        return out

    # ------------------------------------------------------------------ RX --
    def decode(self, e_llr, w_soft=None, rv: int | None = None,
               dynamic_stop: bool = True):
        """e_llr [B, G] -> (tb_bits [B, TBS], tb_ok [B], w_soft list).

        `w_soft`: per-block soft buffers from a previous HARQ round (or None);
        the returned list feeds the next round (reference harq_process->w).
        `rv` must match the transmitter's redundancy version for this round.
        `dynamic_stop=False` forces all n_iter iterations (kernel
        benchmarking; outputs are identical either way).
        """
        cfg, seg = self.cfg, self.seg
        maps = self.maps_by_rv[cfg.rv if rv is None else rv]
        B = e_llr.shape[0]
        pos = 0
        new_w = []
        d_llrs = []
        for r in range(seg.C):
            E = self.Es[r]
            chunk = e_llr[:, pos:pos + E]
            pos += E
            w = rate_match_rx(chunk, maps[r],
                              None if w_soft is None else w_soft[r])
            new_w.append(w)
            d_llrs.append(w_to_d_llr(w, maps[r]))

        # decode grouped by (K, F): same trellis + CRC plan
        results = [None] * seg.C
        by_plan = {}
        for r, K in enumerate(self.block_Ks):
            F = seg.F if r == 0 else 0
            by_plan.setdefault((K, F), []).append(r)
        for (K, F), rs in by_plan.items():
            stacked = jnp.concatenate([d_llrs[r] for r in rs], axis=0)
            kind = "crc24b" if seg.C > 1 else "crc24a"
            dcfg = turbo.TurboDecoderConfig(
                K=K, F=F, n_iter=cfg.n_turbo_iter,
                window=cfg.decoder_window,
                warmup=cfg.decoder_warmup, crc_kind=kind,
                dynamic_stop=dynamic_stop)
            bits, ok = turbo.turbo_decode(stacked, dcfg)
            for i, r in enumerate(rs):
                results[r] = (bits[i * B:(i + 1) * B], ok[i * B:(i + 1) * B])

        payloads = []
        all_ok = jnp.ones(B, bool)
        for r in range(seg.C):
            bits, ok = results[r]
            F = seg.F if r == 0 else 0
            L = 24 if seg.C > 1 else 0
            payloads.append(bits[:, F:bits.shape[1] - L])
            all_ok = all_ok & ok
        b_hat = jnp.concatenate(payloads, axis=1)          # [B, TBS+24]
        # final TB-level CRC24A verification
        H = jnp.asarray(crc_matrix(self.cfg.tbs + 24, "crc24a"), jnp.float32)
        rem = jnp.mod(jnp.matmul(b_hat.astype(jnp.float32), H,
                                 preferred_element_type=jnp.float32), 2.0)
        tb_ok = all_ok & jnp.all(rem < 0.5, axis=-1)
        return b_hat[:, :self.cfg.tbs], tb_ok, new_w
