"""LRC — layered locally-repairable erasure code.

Port of ``ceph_tpu/models/lrc.py``. Parity target:
src/erasure-code/lrc/ErasureCodeLrc.{h,cc}. An LRC profile is a stack of
layers, each a chunks_map string over the full chunk set ('D' data, 'c'
coding, '_' not in layer) plus an inner codec profile; encode walks layers
top-down (ErasureCodeLrc.cc encode_chunks), decode walks bottom-up
re-using chunks recovered by lower layers (decode_chunks), and
minimum_to_decode prefers the layer that can repair with the fewest reads
(:minimum_to_decode, local-repair set search). The k/m/l shorthand
generates the canonical global + per-group-local layer stack (parse_kml,
ErasureCodeLrc.cc:295).

Inner layers are real plugins resolved through the port's registry
(recursive factory, like the reference's layers_init), each on the LRC
codec's own device; the default inner plugin is ``torch_cuda`` on the
torch backend and ``jerasure`` on the numpy one. When every
layer is an element-layout matrix codec of one w, the whole layered
encode and each erasure signature's decode cascade compose into ONE
matrix, applied by one launch of the GF bitmatrix kernel.
"""

from __future__ import annotations

import errno
import json

import numpy as np
import torch

from ..device import resolve_device
from ..ops import gf
from ..utils import profile as profile_util
from .base import ErasureCode, ErasureCodeError
from .matrix_base import MatrixErasureCode
from .table_cache import TableCache


class LrcLayer:
    def __init__(self, chunks_map: str, profile: dict):
        self.chunks_map = chunks_map
        self.profile = profile
        self.data = [i for i, c in enumerate(chunks_map) if c == "D"]
        self.coding = [i for i, c in enumerate(chunks_map) if c == "c"]
        self.chunks = self.data + self.coding
        self.chunks_as_set = set(self.chunks)
        self.codec: ErasureCode | None = None


def _stack(parts, axis=1):
    if isinstance(parts[0], torch.Tensor):
        return torch.stack(parts, dim=axis)
    return np.stack(parts, axis=axis)


def _zeros_like(x):
    if isinstance(x, torch.Tensor):
        return torch.zeros_like(x)
    return np.zeros_like(np.asarray(x))


class Lrc(ErasureCode):
    technique = "lrc"
    DEFAULT_KML = "-1"

    def __init__(self, backend: str = "torch", device=None,
                 default_inner_plugin: str | None = None):
        super().__init__()
        self.backend = backend
        # the numpy backend runs on the host and never touches CUDA
        self.device = resolve_device(device) if backend == "torch" \
            else None
        self.default_inner_plugin = default_inner_plugin or (
            "torch_cuda" if backend == "torch" else "jerasure")
        self.layers: list[LrcLayer] = []
        self.mapping = ""
        self.chunk_count = 0
        self.data_chunk_count = 0
        self.rule_steps: list = [("chooseleaf", "host", 0)]
        self._fusable_cached: bool | None = None
        self._fused_gen: dict | None = None
        self._fused_dec_cache = TableCache()   # bounded LRU, locked

    # -- init --------------------------------------------------------------

    def init(self, profile: dict, errors: list | None = None) -> None:
        self.parse_kml(profile, errors)
        self.rule_root = profile_util.to_string("crush-root", profile,
                                                "default")
        self.rule_device_class = profile_util.to_string(
            "crush-device-class", profile, "")
        layers_desc = profile.get("layers")
        if not layers_desc:
            raise ErasureCodeError(errno.EINVAL,
                                   "could not find 'layers' in profile")
        self._layers_parse(layers_desc)
        self._layers_init()
        mapping = profile.get("mapping")
        if not mapping:
            raise ErasureCodeError(errno.EINVAL,
                                   "the 'mapping' profile is missing")
        self.mapping = mapping
        self.chunk_mapping = profile_util.to_mapping({"mapping": mapping})
        self.data_chunk_count = mapping.count("D")
        self.chunk_count = len(mapping)
        for layer in self.layers:
            if len(layer.chunks_map) != self.chunk_count:
                raise ErasureCodeError(
                    errno.EINVAL,
                    "layer %r must be %d characters long"
                    % (layer.chunks_map, self.chunk_count))
        # a re-init with a new profile drops the fused state
        self._fusable_cached = None
        self._fused_gen = None
        self._fused_dec_cache.clear()
        # kml-generated parameters are not echoed back
        # (ErasureCodeLrc.cc init :547-553)
        if profile.get("l") and profile["l"] != self.DEFAULT_KML:
            profile.pop("mapping", None)
            profile.pop("layers", None)
        self._profile = profile

    def parse_kml(self, profile: dict, errors: list | None = None) -> None:
        # ErasureCodeLrc.cc:295-399
        k = profile_util.to_int("k", profile, self.DEFAULT_KML, errors)
        m = profile_util.to_int("m", profile, self.DEFAULT_KML, errors)
        l = profile_util.to_int("l", profile, self.DEFAULT_KML, errors)
        if k == -1 and m == -1 and l == -1:
            return
        if -1 in (k, m, l):
            raise ErasureCodeError(
                errno.EINVAL, "All of k, m, l must be set or none of them")
        for p in ("mapping", "layers", "crush-steps"):
            if profile.get(p):
                raise ErasureCodeError(
                    errno.EINVAL,
                    "the %s parameter cannot be set when k, m, l are" % p)
        if (k + m) % l:
            raise ErasureCodeError(errno.EINVAL,
                                   "k + m must be a multiple of l")
        groups = (k + m) // l
        if k % groups:
            raise ErasureCodeError(errno.EINVAL,
                                   "k must be a multiple of (k + m) / l")
        if m % groups:
            raise ErasureCodeError(errno.EINVAL,
                                   "m must be a multiple of (k + m) / l")
        mapping = ""
        for _ in range(groups):
            mapping += "D" * (k // groups) + "_" * (m // groups) + "_"
        profile["mapping"] = mapping
        layers = []
        global_map = ""
        for _ in range(groups):
            global_map += "D" * (k // groups) + "c" * (m // groups) + "_"
        layers.append([global_map, ""])
        for i in range(groups):
            local = ""
            for j in range(groups):
                local += ("D" * l + "c") if i == j else "_" * (l + 1)
            layers.append([local, ""])
        profile["layers"] = json.dumps(layers)
        locality = profile.get("crush-locality", "")
        failure_domain = profile.get("crush-failure-domain", "host")
        if locality:
            self.rule_steps = [("choose", locality, groups),
                               ("chooseleaf", failure_domain, l + 1)]
        elif failure_domain:
            self.rule_steps = [("chooseleaf", failure_domain, 0)]

    def _layers_parse(self, description: str) -> None:
        try:
            desc = json.loads(description)
        except json.JSONDecodeError as e:
            raise ErasureCodeError(errno.EINVAL,
                                   "failed to parse layers=%r: %s"
                                   % (description, e))
        if not isinstance(desc, list):
            raise ErasureCodeError(errno.EINVAL,
                                   "layers must be a JSON array")
        self.layers = []
        for pos, entry in enumerate(desc):
            if not isinstance(entry, list) or not entry:
                raise ErasureCodeError(
                    errno.EINVAL,
                    "element %d of layers must be a non-empty array" % pos)
            chunks_map = entry[0]
            if not isinstance(chunks_map, str):
                raise ErasureCodeError(
                    errno.EINVAL, "layer %d chunks map must be a string" % pos)
            prof: dict = {}
            if len(entry) > 1:
                opts = entry[1]
                if isinstance(opts, str):
                    for tok in opts.split():
                        if "=" in tok:
                            key, val = tok.split("=", 1)
                            prof[key] = val
                elif isinstance(opts, dict):
                    prof.update({str(a): str(b) for a, b in opts.items()})
                else:
                    raise ErasureCodeError(
                        errno.EINVAL,
                        "layer %d options must be string or object" % pos)
            self.layers.append(LrcLayer(chunks_map, prof))
        if not self.layers:
            raise ErasureCodeError(errno.EINVAL,
                                   "layers parameter has zero entries")

    def _layers_init(self) -> None:
        # ErasureCodeLrc.cc layers_init: recursive registry factory, every
        # inner codec on this codec's device
        from .. import registry
        for layer in self.layers:
            layer.profile.setdefault("k", str(len(layer.data)))
            layer.profile.setdefault("m", str(len(layer.coding)))
            layer.profile.setdefault("plugin", self.default_inner_plugin)
            layer.profile.setdefault("technique", "reed_sol_van")
            plugin = layer.profile["plugin"]
            inner_profile = {a: b for a, b in layer.profile.items()
                             if a != "plugin"}
            layer.codec = registry.factory(plugin, inner_profile,
                                           device=self.device)

    # -- geometry ----------------------------------------------------------

    def get_chunk_count(self) -> int:
        return self.chunk_count

    def get_data_chunk_count(self) -> int:
        return self.data_chunk_count

    def get_chunk_size(self, object_size: int) -> int:
        return self.layers[0].codec.get_chunk_size(object_size)

    # -- encode ------------------------------------------------------------

    def encode(self, want_to_encode: set, raw) -> dict:
        raw = np.frombuffer(raw, dtype=np.uint8) if isinstance(
            raw, (bytes, bytearray, memoryview)) else np.asarray(
                raw, dtype=np.uint8).reshape(-1)
        blocksize = self.get_chunk_size(raw.size)
        buffers = {i: np.zeros(blocksize, dtype=np.uint8)
                   for i in range(self.chunk_count)}
        data_positions = [i for i, c in enumerate(self.mapping) if c == "D"]
        for di, pos in enumerate(data_positions):
            lo = di * blocksize
            chunk = raw[lo:lo + blocksize]
            buffers[pos][:chunk.size] = chunk
        self.encode_chunks_inplace(set(range(self.chunk_count)), buffers)
        return {i: buffers[i] for i in want_to_encode}

    def encode_chunks_inplace(self, want_to_encode: set, buffers: dict) -> None:
        # ErasureCodeLrc.cc encode_chunks: find the lowest layer that
        # covers everything wanted, then encode from there down.
        top = len(self.layers)
        for layer in reversed(self.layers):
            top -= 1
            if want_to_encode <= layer.chunks_as_set:
                break
        for layer in self.layers[top:]:
            data = np.stack([buffers[c] for c in layer.data])
            parity = layer.codec.encode_batch(data[None])[0]
            for j, c in enumerate(layer.coding):
                buffers[c][:] = np.asarray(parity[j])

    # -- decode ------------------------------------------------------------

    def decode(self, want_to_read: set, chunks: dict) -> dict:
        # ErasureCodeLrc.cc decode_chunks: bottom-up layer walk, each
        # layer re-using chunks recovered by the previous ones.
        have = set(chunks)
        if want_to_read <= have:
            return {i: np.asarray(chunks[i], dtype=np.uint8)
                    for i in want_to_read}
        blocksize = len(next(iter(chunks.values())))
        decoded = {}
        erasures = set()
        for i in range(self.chunk_count):
            if i in chunks:
                decoded[i] = np.asarray(chunks[i], dtype=np.uint8)
            else:
                decoded[i] = np.zeros(blocksize, dtype=np.uint8)
                erasures.add(i)
        want_erasures = want_to_read & erasures
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & erasures
            if len(layer_erasures) > layer.codec.get_coding_chunk_count():
                continue  # too many erasures for this layer
            if not layer_erasures:
                continue
            layer_chunks = {}
            layer_want = set()
            for j, c in enumerate(layer.chunks):
                if c not in erasures:
                    layer_chunks[j] = decoded[c]
                if c in want_to_read or c in layer_erasures:
                    layer_want.add(j)
            try:
                layer_decoded = layer.codec.decode(layer_want, layer_chunks)
            except ErasureCodeError:
                continue
            for j, c in enumerate(layer.chunks):
                if j in layer_decoded:
                    decoded[c] = np.asarray(layer_decoded[j])
                if c in erasures and j in layer_decoded:
                    erasures.discard(c)
            want_erasures = want_to_read & erasures
            if not want_erasures:
                break
        if want_erasures:
            raise ErasureCodeError(
                errno.EIO, "unable to read %s" % sorted(want_erasures))
        return {i: decoded[i] for i in set(want_to_read) | (have & set(decoded))}

    # -- minimum_to_decode -------------------------------------------------

    def minimum_to_decode(self, want_to_read: set, available: set) -> set:
        # ErasureCodeLrc.cc minimum_to_decode: prefer local repair.
        erasures_total = set(range(self.chunk_count)) - set(available)
        erasures_not_recovered = set(erasures_total)
        erasures_want = want_to_read & erasures_total
        if not erasures_want:
            return set(want_to_read)
        minimum: set = set()
        for layer in reversed(self.layers):
            layer_want = want_to_read & layer.chunks_as_set
            if not layer_want:
                continue
            layer_erasures = layer_want & erasures_want
            if not layer_erasures:
                minimum |= layer_want
                continue
            erasures = layer.chunks_as_set & erasures_not_recovered
            if len(erasures) > layer.codec.get_coding_chunk_count():
                continue  # hope an upper layer does better
            minimum |= layer.chunks_as_set - erasures_not_recovered
            for j in erasures:
                erasures_not_recovered.discard(j)
                erasures_want.discard(j)
        if not erasures_want:
            minimum |= set(want_to_read)
            minimum -= erasures_total
            return minimum
        # Case 3 (ErasureCodeLrc.cc): recover chunks even from layers
        # containing nothing we want, hoping the cascade unlocks the
        # upper layers; if everything is recoverable, read all available.
        remaining = set(erasures_total)
        for layer in reversed(self.layers):
            layer_erasures = layer.chunks_as_set & remaining
            if not layer_erasures:
                continue
            if len(layer_erasures) <= layer.codec.get_coding_chunk_count():
                remaining -= layer_erasures
        if not remaining:
            return set(available)
        raise ErasureCodeError(errno.EIO, "not enough chunks to decode")

    # -- single-launch fusion ----------------------------------------------
    #
    # Every LRC layer is a linear map over GF(2^w), so the whole layered
    # encode composes into ONE [m, k] generator and each erasure
    # signature's cascade into ONE compact decode matrix — the layer walk
    # runs SYMBOLICALLY at plan time (host, tiny matrices) and the data
    # path is a single kernel launch, the same shape as plain RS. The
    # per-layer walk (ErasureCodeLrc.cc:744-776 semantics) stays as the
    # path of any other stack and as the fusion's oracle.

    def _fusable(self) -> bool:
        if self.backend != "torch" or not self.layers:
            return False
        if self._fusable_cached is None:
            w0 = getattr(self.layers[0].codec, "w", None)
            self._fusable_cached = all(
                isinstance(layer.codec, MatrixErasureCode)
                and layer.codec.w == w0 and layer.codec.backend == "torch"
                for layer in self.layers)
        return self._fusable_cached

    def _apply_fused(self, entry: dict, data):
        """The fused matrix of `entry` applied by the first layer's codec
        (same w and device as every layer): numpy in, numpy out; a tensor
        in, a tensor out. The entry keeps the device copy."""
        return self.layers[0].codec._apply_matrix(
            entry["gf"], entry["bitmat"], data, entry)

    def _symbolic_encode_rows(self) -> dict:
        """physical position -> [k] GF row over the logical data
        chunks: the layer walk applied to unit vectors."""
        w = self.layers[0].codec.w
        k = self.data_chunk_count
        data_positions = [i for i, c in enumerate(self.mapping)
                          if c == "D"]
        R: dict = {}
        for di, pos in enumerate(data_positions):
            row = np.zeros(k, dtype=np.int64)
            row[di] = 1
            R[pos] = row
        for layer in self.layers:
            D = np.stack([R[c] for c in layer.data])
            P = gf.gf_matmul(np.asarray(layer.codec.coding,
                                        dtype=np.int64), D, w)
            for j, c in enumerate(layer.coding):
                R[c] = P[j]
        return R

    def _fused_encode_entry(self) -> dict:
        if self._fused_gen is None:
            w = self.layers[0].codec.w
            k = self.data_chunk_count
            m = self.chunk_count - k
            R = self._symbolic_encode_rows()
            G = np.stack([R[self.chunk_index(k + j)] for j in range(m)])
            self._fused_gen = {"gf": G,
                               "bitmat": gf.generator_to_bitmatrix(G, w)}
        return self._fused_gen

    def _fused_decode_entry(self, avail_rows: tuple) -> dict:
        """COMPACT [n, len(avail)] GF matrix whose columns follow
        avail_rows order (logical rows): the bottom-up cascade run
        symbolically to its fixpoint, each firing layer one GF
        composition. Applied directly to the caller's stacked chunks —
        no scatter pass."""
        key = tuple(avail_rows)
        entry = self._fused_dec_cache.get(key)
        if entry is not None:
            return entry
        n = self.chunk_count
        w = self.layers[0].codec.w
        S: dict = {}     # physical pos -> [n] GF row over logical rows
        for r in avail_rows:
            row = np.zeros(n, dtype=np.int64)
            row[r] = 1
            S[self.chunk_index(r)] = row
        erasures = set(range(n)) - set(S)
        progress = True
        while erasures and progress:
            progress = False
            for layer in reversed(self.layers):
                layer_erasures = layer.chunks_as_set & erasures
                if not layer_erasures:
                    continue
                k_l = layer.codec.get_data_chunk_count()
                inner_avail = tuple(
                    j for j, c in enumerate(layer.chunks)
                    if c not in erasures)
                if len(inner_avail) < k_l or \
                        len(layer_erasures) > \
                        layer.codec.get_coding_chunk_count():
                    continue
                use = inner_avail[:k_l]
                try:
                    full_gf = layer.codec._decode_entry(use)["gf"]
                except (ErasureCodeError, ValueError):
                    continue
                stacked = np.stack([S[layer.chunks[j]] for j in use])
                full_rows = gf.gf_matmul(
                    np.asarray(full_gf, dtype=np.int64), stacked, w)
                for j, c in enumerate(layer.chunks):
                    if c in erasures:
                        S[c] = full_rows[j]
                        erasures.discard(c)
                        progress = True
        D = np.zeros((n, n), dtype=np.int64)
        recovered = set()
        for i in range(n):
            pos = self.chunk_index(i)
            if pos in S:
                D[i] = S[pos]
                recovered.add(i)
        Dc = D[:, list(avail_rows)]
        entry = {"gf": Dc, "bitmat": gf.generator_to_bitmatrix(Dc, w),
                 "recovered": recovered}
        return self._fused_dec_cache.put(key, entry)

    # -- batch API (one fused launch when fusable; per-layer delegation
    # to the inner codecs otherwise) --------------------------------------

    DECODE_BATCH_ANY = True

    def encode_batch(self, data):
        """[B, k, N] (logical data order) -> [B, n-k, N] parity in
        logical parity order (chunk_index(k+j) gives the physical
        position of output row j). Fusable stacks: the precomposed
        [m, k] generator in ONE kernel launch; otherwise walks every
        layer top-down, each layer one batched inner-codec encode."""
        if self._fusable():
            return self._apply_fused(self._fused_encode_entry(), data)
        return self._encode_batch_layers(data)

    def _encode_batch_layers(self, data):
        k = self.data_chunk_count
        data_positions = [i for i, c in enumerate(self.mapping)
                          if c == "D"]
        bufs: dict = {}
        for di, pos in enumerate(data_positions):
            bufs[pos] = data[:, di]
        for layer in self.layers:
            layer_data = _stack([bufs[c] for c in layer.data])
            parity = layer.codec.encode_batch(layer_data)
            for j, c in enumerate(layer.coding):
                bufs[c] = parity[:, j]
        m = self.chunk_count - k
        return _stack([bufs[self.chunk_index(k + j)] for j in range(m)])

    def decode_batch(self, avail_rows: tuple, chunks,
                     want_rows: tuple | None = None):
        """Batched reconstruction: avail_rows is ANY recoverable subset
        of logical rows (local repairs hand over fewer than k). Fusable
        stacks: the cascade precomposed into one compact matrix, ONE
        kernel launch per signature. Otherwise a bottom-up layer walk,
        each firing layer one batched inner-codec decode. Both run the
        cascade to its fixpoint: every recoverable row comes back
        filled, unrecoverable and unwanted rows come back zero (and must
        not be consumed)."""
        if self._fusable():
            return self._decode_batch_fused(avail_rows, chunks, want_rows)
        return self._decode_batch_layers(avail_rows, chunks, want_rows)

    def _decode_batch_fused(self, avail_rows: tuple, chunks,
                            want_rows: tuple | None = None):
        n = self.chunk_count
        avail = set(avail_rows)
        if want_rows is None:
            want = set(range(n)) - avail
        else:
            want = set(want_rows) - avail
        entry = self._fused_decode_entry(tuple(avail_rows))
        still = want - entry["recovered"]
        if still:
            raise ErasureCodeError(
                errno.EIO, "unable to read %s" % sorted(still))
        return self._apply_fused(entry, chunks)

    def _decode_batch_layers(self, avail_rows: tuple, chunks,
                             want_rows: tuple | None = None):
        n = self.chunk_count
        avail_phys = {self.chunk_index(r) for r in avail_rows}
        if want_rows is None:
            want_phys = set(range(n)) - avail_phys
        else:
            want_phys = ({self.chunk_index(r) for r in want_rows}
                         - avail_phys)
        row_of = {r: i for i, r in enumerate(avail_rows)}
        bufs: dict = {}
        for r in avail_rows:
            bufs[self.chunk_index(r)] = chunks[:, row_of[r]]
        erasures = set(range(n)) - set(bufs)
        progress = True
        # fixpoint, not first-want-satisfied: both paths then return the
        # same rows filled (every recoverable one), which keeps the fused
        # path byte-equal to this oracle
        while erasures and progress:
            progress = False
            for layer in reversed(self.layers):
                layer_erasures = layer.chunks_as_set & erasures
                if not layer_erasures:
                    continue
                k_l = layer.codec.get_data_chunk_count()
                inner_avail = tuple(
                    j for j, c in enumerate(layer.chunks)
                    if c not in erasures)
                if len(inner_avail) < k_l or \
                        len(layer_erasures) > \
                        layer.codec.get_coding_chunk_count():
                    continue
                use = inner_avail[:k_l]
                stacked = _stack([bufs[layer.chunks[j]] for j in use])
                try:
                    full = layer.codec.decode_batch(use, stacked)
                except ErasureCodeError:
                    continue
                for j, c in enumerate(layer.chunks):
                    if c in erasures:
                        bufs[c] = full[:, j]
                        erasures.discard(c)
                        progress = True
        still = want_phys & erasures
        if still:
            raise ErasureCodeError(
                errno.EIO, "unable to read %s" % sorted(still))
        zeros = None
        out = []
        for i in range(n):
            pos = self.chunk_index(i)
            if pos in bufs:
                out.append(bufs[pos])
            else:
                if zeros is None:
                    zeros = _zeros_like(chunks[:, 0])
                out.append(zeros)
        return _stack(out)
