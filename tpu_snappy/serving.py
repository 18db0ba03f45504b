"""Dynamic-batching codec server: concurrent requests -> device waves.

The reference is a single-job accelerator: one RoCC `compress(src, dst)`
command runs at a time and the core spins on the response
(tests/compression.c:41-61). A device deployment serves MANY concurrent
callers, and the device wants fixed-shape batched work — so the serving
layer's job is to turn an arbitrary arrival process into full waves:

  caller threads --submit--> block/fragment work-unit queue
                             (a request fans out into 64 KB units)
        batcher thread --collect up to `wave` units, or until the
                         oldest unit has waited `max_wait_ms`-->
        one jitted dispatch per wave (fixed shapes => one compiled
        graph per kind, reused forever), submitted WITHOUT syncing:
        up to PIPELINE_DEPTH waves ride the device queue while the
        batcher packs the next and fetches the oldest, so waves of
        different kinds overlap instead of serializing on host syncs
        --per-unit results--> request assembly --> caller futures

Batching is what buys throughput on the device (a per-dispatch floor,
lockstep waves); max_wait bounds the latency a lone request pays for it. Sub-block requests skip the queue
entirely and run on the host codec inline (api.SMALL_INPUT_BYTES
economics: a tiny job should cost microseconds, not a device wave).

Error isolation is per-request: a corrupt stream fails its own future
(same validation + host-fallback ladder as api.decompress); neighbors
in the same wave are unaffected (their fragments' ok flags are
independent by construction).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np

from . import api
from . import format as fmt
from .config import CodecConfig, DEFAULT_CONFIG
from .ops import decode as ops_decode
from .ops import encode as ops_encode


@dataclasses.dataclass
class ServerStats:
    requests: int = 0
    host_fastpath: int = 0
    units: int = 0
    waves: int = 0
    wave_slots: int = 0
    #: Dispatched waves per kind (enc/dec/scd).
    waves_by_kind: dict = dataclasses.field(default_factory=dict)
    #: Fragments re-decoded on the host because their device pass flagged
    #: them (fragment-granular fallback — NOT whole requests).
    spliced_fragments: int = 0
    #: Whole streams the fragment table refused (FragmentFallback),
    #: decoded on the host instead of the device.
    fallback_streams: int = 0
    latencies_s: list = dataclasses.field(default_factory=list)

    @property
    def occupancy(self) -> float:
        """Mean fraction of wave slots carrying real work (1.0 = every
        dispatch was full — the arrival process kept the device fed)."""
        return self.units / self.wave_slots if self.wave_slots else 0.0

    def latency_percentiles(self, qs=(50, 95, 99)) -> dict:
        """Request latency (submit -> future resolution) percentiles in
        milliseconds, over device-batched requests (the host fast-path
        is not tracked; it is µs-scale by construction)."""
        if not self.latencies_s:
            return {f"p{q}": None for q in qs}
        arr = np.asarray(self.latencies_s)
        return {f"p{q}": round(float(np.percentile(arr, q)) * 1e3, 3)
                for q in qs}


class _Request:
    """One caller request fanned out into `n` work units.

    kind: 'enc'/'dec' (raw Snappy) or 'encf'/'decf' (framed container —
    same device waves, container assembly at completion)."""

    def __init__(self, kind: str, n: int, total: int):
        self.kind = kind
        self.t0 = time.monotonic()
        #: Enqueue time — set when the units actually reach the batcher
        #: queues. Wave ripeness keys off THIS, not t0: host-side prep
        #: between request creation and enqueue (e.g. framed sidecar
        #: parsing) must not consume the max_wait coalescing window, or
        #: slow-prep requests would be born ripe and dispatch partial.
        self.tq = self.t0
        self.future: Future = Future()
        self.parts: list[bytes | None] = [None] * n
        self.missing = n
        self.total = total
        self.failed = False  # decode: some fragment failed device checks
        self.frags = None    # decode: (F, cap) uint8 for the host fallback
        self.clens = None
        self.ulens = None
        self.oks = [True] * n  # decode: per-fragment device validation
        self.raw = None      # framed encode: original bytes (CRCs/fallback)
        self.lengths = None  # framed encode: per-block uncompressed sizes
        self.sidecar = "off"  # framed encode: sidecar emission policy
        self.chunks = None   # framed decode: parsed chunk descriptors

    def deliver(self, idx: int, part: bytes) -> bool:
        self.parts[idx] = part
        self.missing -= 1
        return self.missing == 0


class CodecServer:
    """Thread-safe compress/decompress service with dynamic batching.

    wave: work units (64 KB blocks / fragments) per device dispatch
    (per DEVICE when a mesh is given — a mesh dispatch carries
    wave x n_devices slots, data-parallel sharded).
    max_wait_ms: longest a unit waits for wave-mates before a partial
    wave dispatches anyway (the usual throughput/latency knob).
    mesh: a jax.sharding.Mesh to serve over every chip at once — the
    batcher is unchanged, each dispatch just spans the mesh (block DP,
    the same shardings as parallel/shard.py).
    max_pending: backpressure bound — submit calls block while this many
    work units are already queued (None = unbounded).
    Use as a context manager, or call close()."""

    def __init__(self, cfg: CodecConfig = DEFAULT_CONFIG, wave: int = 8,
                 max_wait_ms: float = 2.0, mesh=None,
                 max_pending: int | None = None):
        self._cfg = cfg
        self._mesh = mesh
        self._wave = wave * (mesh.devices.size if mesh is not None else 1)
        self._max_wait = max_wait_ms / 1e3
        self._max_pending = max_pending
        self._lock = threading.Condition()
        # Separate queues per kind: the encode, decode and sidecar-decode
        # graphs differ, so a wave is single-kind —
        # but waves of DIFFERENT kinds overlap on the device through the
        # depth-2 submit pipeline (_run), so kind diversity no longer
        # serializes on host syncs. Entries: (request, unit_idx, *unit).
        self._q: dict[str, deque] = {"enc": deque(), "dec": deque(),
                                     "scd": deque()}
        self._closing = False
        self.stats = ServerStats()
        import jax
        # One fixed-shape jitted graph per kind (decode_fragments_jit is
        # already jitted; widths bucket to few variants).
        cfg_c = self._cfg
        if mesh is not None:
            from .parallel import mesh as meshlib, shard
            self._shard = shard
            self._bspec = meshlib.block_sharding(mesh)
            self._sspec = meshlib.scalar_sharding(mesh)
            enc_fn = shard._encode_fn(mesh, cfg_c, wave)
            dec_fn = shard._decode_fn(mesh, cfg_c.dp_axis, wave)

            def _enc(b, l):
                return enc_fn(jax.device_put(b, self._bspec),
                              jax.device_put(l, self._sspec))

            def _enc_fetch(h):
                return shard.fetch_global(h[0]), shard.fetch_global(h[1])

            def _dec(f, c, u):
                return dec_fn(jax.device_put(f, self._bspec),
                              jax.device_put(c, self._sspec),
                              jax.device_put(u, self._sspec))

            def _dec_fetch(h):
                return shard.fetch_global(h[0]), shard.fetch_global(h[1])

            self._enc, self._dec = _enc, _dec
            self._enc_fetch, self._dec_fetch = _enc_fetch, _dec_fetch
        else:
            self._enc = jax.jit(
                lambda b, l: ops_encode.encode_blocks(b, l, cfg_c))
            self._dec = ops_decode.decode_fragments_jit
            self._enc_fetch = self._dec_fetch = (
                lambda h: (np.asarray(h[0]), np.asarray(h[1])))
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="tpu-snappy-batcher")
        self._worker.start()

    # ---- caller side ----

    def compress(self, data: bytes) -> Future:
        """Future[bytes]: standard Snappy stream of `data`."""
        self._note_request()
        if len(data) < api.SMALL_INPUT_BYTES and self._cfg == DEFAULT_CONFIG:
            return self._host(api._host_compress, data)
        blocks, lengths = api._to_blocks(data, self._cfg.block_size)
        req = _Request("enc", len(lengths), len(data))
        with self._lock:
            self._ensure_open()
            self._wait_capacity()
            req.tq = time.monotonic()
            for i in range(len(lengths)):
                self._q["enc"].append((req, i, blocks[i], int(lengths[i])))
            self._lock.notify_all()
        return req.future

    def decompress(self, comp: bytes) -> Future:
        """Future[bytes]: decoded payload; malformed input raises
        ValueError through the future (never synchronously)."""
        self._note_request()
        try:
            total, start = fmt.varint_decode(comp)
            if (total < api.SMALL_INPUT_BYTES
                    and self._cfg == DEFAULT_CONFIG):
                return self._host(api.decompress, comp)
            frags, clens, ulens = ops_decode.fragment_table(comp, start,
                                                            total)
        except ops_decode.FragmentFallback:
            from . import reference_codec
            with self._lock:
                self.stats.fallback_streams += 1
            return self._host(reference_codec.decompress, comp)
        except ValueError as e:
            fut: Future = Future()
            fut.set_exception(e)
            return fut
        req = _Request("dec", len(ulens), total)
        req.frags, req.clens = frags, np.asarray(clens)
        req.ulens = np.asarray(ulens)
        with self._lock:
            self._ensure_open()
            self._wait_capacity()
            req.tq = time.monotonic()
            for i in range(len(ulens)):
                self._q["dec"].append(
                    (req, i, frags[i], int(clens[i]), int(ulens[i])))
            self._lock.notify_all()
        return req.future

    def compress_framed(self, data: bytes, sidecar: str = "off") -> Future:
        """Future[bytes]: framed container stream (framing_format.txt —
        chunked, per-chunk CRC-32C). Blocks ride the SAME encode waves as
        raw requests (one compiled graph serves both kinds); container
        assembly — CRCs, compressed-vs-uncompressed chunk choice, optional
        fast-decode sidecars (`sidecar` as in framing.compress) — happens
        at completion."""
        from . import framing

        self._note_request()
        if not data:
            fut: Future = Future()
            fut.set_result(framing.STREAM_ID)
            return fut
        blocks, lengths = api._to_blocks(data, framing.MAX_CHUNK)
        req = _Request("encf", len(lengths), len(data))
        req.raw, req.lengths, req.sidecar = data, lengths, sidecar
        with self._lock:
            self._ensure_open()
            self._wait_capacity()
            req.tq = time.monotonic()
            for i in range(len(lengths)):
                self._q["enc"].append((req, i, blocks[i], int(lengths[i])))
            self._lock.notify_all()
        return req.future

    def decompress_framed(self, framed: bytes) -> Future:
        """Future[bytes]: decoded framed stream with full validation
        (structure + every chunk CRC). Compressed chunks batch through the
        same fragment waves as raw decode requests; chunks carrying a
        usable fast-decode sidecar take the sidecar wave kind instead
        (scatter+ffill+gather), with the chunk CRC gating
        the result either way."""
        from . import framing
        from . import sidecar as sc

        self._note_request()
        try:
            chunks = framing._parse_chunks(framed)
        except ValueError as e:
            fut: Future = Future()
            fut.set_exception(e)
            return fut
        datach = []   # (type, body) data chunks, in order
        side = []     # parallel: sidecar payload bytes or None
        pend_s = None
        for t, off, ln in chunks:
            body = framed[off: off + ln]
            if t == framing.CHUNK_SIDECAR:
                pend_s = body
            elif t == framing.CHUNK_COMPRESSED:
                datach.append((t, body))
                side.append(pend_s)
                pend_s = None
            elif t == framing.CHUNK_UNCOMPRESSED:
                datach.append((t, body))
                side.append(None)
                pend_s = None
        dec_units, scd_units, over_ids = [], [], []
        for i, (t, body) in enumerate(datach):
            if t != framing.CHUNK_COMPRESSED:
                continue
            try:
                ulen, vstart = fmt.varint_decode(body[4:])
            except ValueError as e:
                fut = Future()
                fut.set_exception(ValueError(f"chunk {i}: {e}"))
                return fut
            payload = body[4 + vstart:]
            if ulen > framing.MAX_CHUNK:
                fut = Future()
                fut.set_exception(ValueError(
                    "chunk uncompressed size exceeds 65536"))
                return fut
            sv = None
            if side[i] is not None and 0 < ulen and len(payload) < sc.OUT:
                parsed = sc.parse(side[i])
                if parsed is not None:
                    sv = sc.prep_parent(*parsed, int(ulen))
            if sv is not None:
                scd_units.append((i, payload, int(ulen), sv[0], sv[1]))
            elif len(payload) > ops_decode.FRAG_CAP:
                # Spec-valid but beyond the device fragment capacity (an
                # adversarial all-literal 64 KB chunk compresses to
                # ~131 KB): never enqueue it — a capacity-width batch row
                # cannot hold it and the whole wave would fail. Mark it
                # not-ok; _assemble_framed re-decodes it on the host, the
                # same route framing._decode_data_chunks uses.
                over_ids.append(i)
            else:
                dec_units.append((i, payload, len(payload), int(ulen)))
        n_units = len(dec_units) + len(scd_units) + len(over_ids)
        req = _Request("decf", max(1, n_units),
                       sum(len(b) - 4 for _t, b in datach))
        req.chunks = datach
        if n_units == 0:
            # Uncompressed/empty stream: settle inline (CRCs still checked).
            try:
                self._resolve(req, self._assemble_framed(req))
            except ValueError as e:
                self._resolve(req, exc=e)
            return req.future
        req.oks = [True] * n_units
        req.chunk_ids = ([u[0] for u in dec_units]
                         + [u[0] for u in scd_units] + over_ids)
        # Settle oversize chunks up front (host path at assembly); when
        # every unit is oversize this resolves the request inline.
        base = len(dec_units) + len(scd_units)
        for j in range(len(over_ids)):
            req.oks[base + j] = False
            if req.deliver(base + j, b""):
                try:
                    self._resolve(req, self._assemble_framed(req))
                except ValueError as e:
                    self._resolve(req, exc=e)
                return req.future
        with self._lock:
            self._ensure_open()
            self._wait_capacity()
            req.tq = time.monotonic()
            for j, (_i, payload, cl, ul) in enumerate(dec_units):
                self._q["dec"].append(
                    (req, j, np.frombuffer(payload, np.uint8), cl, ul))
            for j, (_i, payload, ul, s2, vals) in enumerate(scd_units):
                self._q["scd"].append(
                    (req, len(dec_units) + j,
                     np.frombuffer(payload, np.uint8), ul, s2, vals))
            self._lock.notify_all()
        return req.future

    def _assemble_framed(self, req: _Request) -> bytes:
        """Container assembly for framed requests (CRC verify everywhere;
        device-flagged or CRC-mismatching compressed chunks re-decode on
        the host — chunks are independent, so no cross-chunk context)."""
        from . import framing, reference_codec

        cid = {i: j for j, i in enumerate(getattr(req, "chunk_ids", []))}
        out = []
        for i, (t, body) in enumerate(req.chunks):
            want = framing.unmask(int.from_bytes(body[:4], "little"))
            if t == framing.CHUNK_UNCOMPRESSED:
                piece = body[4:]
                if len(piece) > framing.MAX_CHUNK:
                    raise ValueError("uncompressed chunk exceeds 65536")
                crc = framing.crc32c(piece)
            else:
                j = cid[i]
                piece = req.parts[j] if req.oks[j] else None
                crc = framing.crc32c(piece) if piece is not None else None
                if crc != want:
                    try:
                        piece = reference_codec.decompress(body[4:])
                    except ValueError as e:
                        raise ValueError(f"chunk {i}: {e}") from e
                    crc = framing.crc32c(piece)
                    with self._lock:
                        self.stats.spliced_fragments += 1
            if crc != want:
                raise ValueError(f"chunk {i}: CRC-32C mismatch")
            out.append(piece)
        return b"".join(out)

    def close(self) -> None:
        """Drain the queues, then stop the batcher."""
        with self._lock:
            self._closing = True
            self._lock.notify_all()
        self._worker.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- internals ----

    def _note_request(self):
        with self._lock:
            self.stats.requests += 1

    def _ensure_open(self):
        if self._closing:
            raise RuntimeError("CodecServer is closed")

    def _wait_capacity(self):
        """Backpressure: block the submitter while the unit queue is at
        max_pending (called under self._lock)."""
        if self._max_pending is None:
            return
        while (sum(len(q) for q in self._q.values())
               >= self._max_pending):
            if self._closing:
                raise RuntimeError("CodecServer is closed")
            self._lock.wait(0.05)

    def _resolve(self, req: _Request, result=None, exc=None):
        with self._lock:
            self.stats.latencies_s.append(time.monotonic() - req.t0)
        if exc is not None:
            req.future.set_exception(exc)
        else:
            req.future.set_result(result)

    def _host(self, fn, data) -> Future:
        fut: Future = Future()
        try:
            fut.set_result(fn(data))
            with self._lock:
                self.stats.host_fastpath += 1
        except (ValueError, RuntimeError) as e:
            fut.set_exception(e)
        return fut

    def _take_batch(self, wait: bool = True):
        """Next ripe wave: a kind is ripe when it holds a full wave, its
        head unit has waited max_wait, or the server is draining. Returns
        (kind, units); (None, ()) = closed and drained; ("", ()) = nothing
        ripe right now (only when wait=False — the pipelined _run passes
        that while device waves are still in flight, so it can spend the
        wait completing one instead of sleeping)."""
        with self._lock:
            while True:
                now = time.monotonic()
                ripe = [k for k, q in self._q.items() if q and (
                    len(q) >= self._wave or self._closing
                    or q[0][0].tq + self._max_wait <= now)]
                if ripe:
                    # Prefer the fullest ripe kind (fair via FIFO heads).
                    kind = max(ripe, key=lambda k: len(self._q[k]))
                    break
                if self._closing and not any(self._q.values()):
                    return None, ()
                if not wait:
                    return "", ()
                heads = [q[0][0].tq + self._max_wait
                         for q in self._q.values() if q]
                self._lock.wait(max(1e-4, min(heads) - now)
                                if heads else 0.1)
            units = [self._q[kind].popleft()
                     for _ in range(min(self._wave, len(self._q[kind])))]
            self.stats.waves += 1
            self.stats.wave_slots += self._wave
            self.stats.units += len(units)
            self.stats.waves_by_kind[kind] = (
                self.stats.waves_by_kind.get(kind, 0) + 1)
            self._lock.notify_all()  # wake backpressured submitters
            return kind, units

    #: Device waves in flight before the batcher syncs the oldest. Depth 2
    #: overlaps wave k's host work (result fetch + assembly + next-wave
    #: packing) with wave k+1's device execution — and lets waves of
    #: DIFFERENT kinds queue back-to-back on the device instead of
    #: serializing on a host sync between kinds (each kind keeps its own
    #: compiled graph; the device stream interleaves them in-order).
    PIPELINE_DEPTH = 2

    def _run(self):
        pending: deque = deque()  # (kind, units, device handles)
        while True:
            try:
                kind, units = self._take_batch(wait=not pending)
            except Exception:  # pragma: no cover - defensive
                continue
            if kind == "":
                # Nothing ripe: spend the wait syncing the oldest in-flight
                # wave (its results are due before a new wave ripens).
                self._complete_one(pending)
                continue
            if kind is None:
                while pending:
                    self._complete_one(pending)
                return
            try:
                pending.append((kind, units, self._submit(kind, units)))
            except Exception as e:  # dispatch-level failure: fail the wave
                for req, *_ in units:
                    if not req.future.done():
                        self._resolve(req, exc=e)
            # max(1, ...): depth <= 0 would pop an empty deque and kill
            # the batcher thread (the knob is instance-assignable).
            while len(pending) >= max(1, self.PIPELINE_DEPTH):
                self._complete_one(pending)

    def _submit(self, kind: str, units):
        """Pack a wave and dispatch its jitted graph WITHOUT syncing —
        returns device handles for _complete_one."""
        if kind == "enc":
            return self._submit_encode(units)
        if kind == "scd":
            return self._submit_sidecar(units)
        return self._submit_decode(units)

    def _complete_one(self, pending: deque):
        kind, units, handles = pending.popleft()
        try:
            if kind == "enc":
                self._complete_encode(units, handles)
            elif kind == "scd":
                self._complete_sidecar(units, handles)
            else:
                self._complete_decode(units, handles)
        except Exception as e:  # device-level failure: fail the wave
            for req, *_ in units:
                if not req.future.done():
                    self._resolve(req, exc=e)

    def _submit_encode(self, units):
        W = self._wave
        blocks = np.zeros((W, fmt.BLOCK_SIZE), np.uint8)
        lens = np.zeros(W, np.int32)
        for j, (_req, _i, row, ln) in enumerate(units):
            blocks[j] = row
            lens[j] = ln
        return self._enc(blocks, lens)

    def _complete_encode(self, units, handles):
        out, out_lens = self._enc_fetch(handles)
        for j, (req, i, _row, _ln) in enumerate(units):
            if req.deliver(i, out[j, : out_lens[j]].tobytes()):
                if req.kind == "encf":
                    self._resolve(req, self._assemble_framed_enc(req))
                else:
                    body = b"".join(req.parts)
                    self._resolve(req, fmt.varint_encode(req.total) + body)

    def _assemble_framed_enc(self, req: _Request) -> bytes:
        """Framed container assembly from the wave-encoded element parts
        (per-chunk CRC over the original bytes; the spec's uncompressed-
        chunk rule where compression does not shrink; optional sidecars)."""
        from . import framing

        parts = [framing.STREAM_ID]
        pos = 0
        for i in range(len(req.lengths)):
            blen = int(req.lengths[i])
            raw = req.raw[pos: pos + blen]
            crc = framing.crc32c(raw)
            elems = req.parts[i]
            payload = fmt.varint_encode(blen) + elems
            if len(payload) < blen:
                parts.append(framing._sidecar_chunk(elems, blen,
                                                    req.sidecar))
                body = framing.mask(crc).to_bytes(4, "little") + payload
                parts.append(bytes([framing.CHUNK_COMPRESSED])
                             + len(body).to_bytes(3, "little") + body)
            else:
                body = framing.mask(crc).to_bytes(4, "little") + raw
                parts.append(bytes([framing.CHUNK_UNCOMPRESSED])
                             + len(body).to_bytes(3, "little") + body)
            pos += blen
        return b"".join(parts)

    def _submit_decode(self, units):
        W = self._wave
        clens = np.zeros(W, np.int32)
        ulens = np.zeros(W, np.int32)
        for j, (_req, _i, _frag, cl, ul) in enumerate(units):
            clens[j] = cl
            ulens[j] = ul
        width = ops_decode.frag_width(clens)
        frags = np.zeros((W, width), np.uint8)
        for j, (_req, _i, frag, cl, _ul) in enumerate(units):
            frags[j, :cl] = frag[:cl]
        return self._dec(frags, clens, ulens)

    def _complete_decode(self, units, handles):
        out, ok = self._dec_fetch(handles)
        for j, (req, i, _frag, _cl, ul) in enumerate(units):
            if not ok[j]:
                # Exotic-but-valid (e.g. a cross-fragment copy) or corrupt.
                # Mark and keep counting units; the failed fragments (and
                # ONLY those) re-decode on the host once all the request's
                # waves are in — neighbors in this wave are unaffected.
                req.failed = True
                req.oks[i] = False
            if req.deliver(i, out[j, :ul].tobytes()):
                if req.kind == "decf":
                    try:
                        self._resolve(req, self._assemble_framed(req))
                    except ValueError as e:
                        self._resolve(req, exc=e)
                elif req.failed:
                    self._settle_spliced(req)
                else:
                    self._resolve(req, b"".join(req.parts))

    def _submit_sidecar(self, units):
        """Sidecar fast-decode wave: units are framed chunks whose 0x80
        sidecar parsed cleanly. Shapes bucket per wave (piece and element
        widths), so the graph count stays bounded; a CRC mismatch at
        assembly routes the chunk to the host in _assemble_framed — the
        sidecar stays a pure hint."""
        from . import sidecar as sc

        return sc.decode_chunks_jit(*sc.pack_batch(
            [(u[2].tobytes(), u[3], u[4], u[5]) for u in units]))

    def _complete_sidecar(self, units, handles):
        out = np.asarray(handles)
        for j, (req, i, _payload, ul, _s2, _vals) in enumerate(units):
            if req.deliver(i, out[j, :ul].tobytes()):
                try:
                    self._resolve(req, self._assemble_framed(req))
                except ValueError as e:
                    self._resolve(req, exc=e)

    def _settle_spliced(self, req: _Request):
        """Fragment-granular host fallback: splice the ok fragments'
        device bytes and re-decode only the flagged ones sequentially,
        with the spliced prefix as copy context (api._splice_parts —
        the same mechanism api.decompress uses). Decodes valid-but-exotic
        streams; raises precisely for corrupt ones."""
        try:
            result = api._splice_parts(req.frags, req.clens, req.ulens,
                                       req.parts, req.oks)
            if len(result) != req.total:
                raise ValueError(
                    f"invalid Snappy stream: decoded {len(result)} bytes, "
                    f"preamble said {req.total}")
            with self._lock:
                self.stats.spliced_fragments += req.oks.count(False)
            self._resolve(req, result)
        except (ValueError, IndexError) as e:
            self._resolve(req, exc=ValueError(str(e)))
