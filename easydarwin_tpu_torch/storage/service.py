"""Erasure-coded storage of finalized DVR assets: one node's shard store,
scrub and repair, and the restore reads of the spill chain.

A copy of the reference's ``storage/service.py`` with its ``obs`` sites
(``storage_shards_total`` by kind a placed or repaired shard,
``storage_scrub_errors_total``, ``storage_repairs_total`` and
``_repair_bytes_total``, the ``storage.store``, ``storage.scrub_error``
and ``storage.repair`` events), over the port's ``StripeCodec`` (B4, ``ed_gf_parity``
on the card).  Every finalized asset is sharded into ``k`` data + ``m``
parity window shards a track: data shard ``j`` of stripe ``s`` is the
raw spill blob of the stripe's ``j``-th window, the parity shards are
the codec's device products, each checked against the host product
(with ``use_device`` off, the server's ``storage_device = false``: the
host products alone, and ``stats()["host_products"]`` counts them).
Shards are files ``<root>/<asset>/t{track}/s{stripe}.{idx}`` beside a
``manifest.json`` (stripe geometry, per-shard lengths and crc32s, the
holder map and the asset's DVR meta/index document).

Reads: ``restore_window`` serves a window blob from its local shard
file, or reconstructs it byte-exactly from any ``k`` surviving shards of
its stripe (one gather and one device product serve the whole stripe,
kept in a small stripe cache).  ``scrub_tick`` re-verifies local shards
against the manifest's crc32s and, when a stripe's data shards are all
local, re-derives each parity shard through the host GF product; a bad
shard is counted, quarantined and queued for repair.  ``repair_now``
re-materializes one shard as math over the survivors (a reconstruct for
data, the parity product for parity), not a byte copy.

The cluster hooks (``peer_nodes``, ``ring_for``, ``push_shard``,
``fetch_shard``, ``fetch_manifest``) are kept and stay None in a
single-node server: every shard is local.  Errors the reference logs
and swallows are counted (``reconstruct_failures``, ``repair_errors``,
``worker_errors`` for a worker job that raised) with their tracebacks on
stderr.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
import traceback
import zlib

import numpy as np
import torch

from .. import obs
from ..cluster.placement import SHARD_KEY_PREFIX, shard_key
from ..protocol.sdp import _norm
from ..relay.fec import coeff_rows, gf_matmul
from ..utils.paths import confined_subpath
from .codec import StorageError, StripeCodec

MANIFEST_VERSION = 1


def shard_name(track: int, stripe: int, idx: int) -> str:
    return f"t{int(track)}/s{int(stripe)}.{int(idx)}"


class StorageService:
    """One node's shard store, scrub and repair workers and restore
    reads, with the stripe products on ``device`` (``use_device`` off:
    on the host alone, ``StripeCodec``'s)."""

    #: local shards crc-verified per scrub tick
    SCRUB_BATCH = 32

    def __init__(self, root: str, node_id: str, *, k: int = 4,
                 m: int = 2, device: str | torch.device = "cuda",
                 use_device: bool = True):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.node_id = str(node_id)
        self.codec = StripeCodec(k, m, device=device, use_device=use_device)
        self.k, self.m = self.codec.k, self.codec.m
        # -- cluster hooks (None: a single-node store) --
        #: () -> dict[node_id, lease_meta] of live nodes
        self.peer_nodes = None
        #: (nodes) -> HashRing
        self.ring_for = None
        #: (node_meta, asset, name, payload, manifest_json) -> bool
        self.push_shard = None
        #: (node_meta, asset, name) -> bytes | None
        self.fetch_shard = None
        #: (node_meta, asset) -> dict | None
        self.fetch_manifest = None
        # -- state --
        self._lock = threading.Lock()
        self._manifests: dict[str, dict] = {}
        #: fenced claims a cluster tick would drain: [(key, record)]
        self._pending_claims: list[tuple[str, dict]] = []
        self._repair_inflight: set[tuple[str, str]] = set()
        self._repair_queue: list[tuple[str, str]] = []
        self._pool = None
        self._scrub_cursor: list[tuple[str, str]] = []
        self._closed = False
        #: one solve serves a whole stripe: {(asset, tid, s, gen):
        #: {data_idx: blob}}, FIFO-bounded
        self._stripe_cache: dict[tuple, dict[int, bytes]] = {}
        self._stripe_cache_max = 8
        #: asset → dir and (dir, shard name) → file resolutions
        self._dir_cache: dict = {}
        # -- counters --
        self.stored_assets = 0
        self.shards_local = 0
        self.shards_pushed = 0
        self.push_failures = 0
        self.reconstructs = 0
        self.reconstruct_failures = 0
        self.repairs = 0
        self.repair_bytes = 0
        self.repair_errors = 0
        self.scrub_errors = 0
        self.scrubbed = 0
        self.worker_errors = 0
        #: host ns: ``store_asset`` calls, and the gathers of the
        #: reconstructs (their products and checks are the codec's)
        self.store_calls = 0
        self.store_ns = 0
        self.gathers = 0
        self.gather_ns = 0

    # ------------------------------------------------------------ geometry
    def _dir_for(self, asset: str) -> str | None:
        key = _norm(asset)
        try:
            return self._dir_cache[key]
        except KeyError:
            pass
        p = confined_subpath(self.root, key)
        if len(self._dir_cache) >= 1024:
            self._dir_cache.clear()
        self._dir_cache[key] = p
        return p

    def _placement_target(self, ring, key: str, name: str) -> str:
        """Rank the stripe on the ring and deal shard ``idx`` round-robin
        down the candidates, so a fleet ``k + m`` wide loses at most one
        shard of a stripe per node death."""
        stem, _, idx_s = name.rpartition(".")
        try:
            idx = int(idx_s)
        except ValueError:
            idx = 0
        rank = ring.rank(f"{key}/{stem}")
        if not rank:
            return self.node_id
        return rank[idx % len(rank)]

    def _shard_path(self, asset: str, name: str) -> str | None:
        adir = self._dir_for(asset)
        if adir is None:
            return None
        ck = (adir, name)
        try:
            return self._dir_cache[ck]
        except KeyError:
            pass
        p = confined_subpath(adir, name)
        if len(self._dir_cache) >= 1024:
            self._dir_cache.clear()
        self._dir_cache[ck] = p
        return p

    # ------------------------------------------------------------ manifest
    def manifest(self, asset: str) -> dict | None:
        """The asset's manifest: memory, then disk."""
        key = _norm(asset)
        with self._lock:
            doc = self._manifests.get(key)
        if doc is not None:
            return doc
        adir = self._dir_for(asset)
        if adir is None:
            return None
        try:
            with open(os.path.join(adir, "manifest.json"),
                      encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return None
        if not isinstance(doc, dict) \
                or doc.get("version") != MANIFEST_VERSION:
            return None
        with self._lock:
            self._manifests[key] = doc
        return doc

    def _write_manifest(self, asset: str, doc: dict) -> bool:
        adir = self._dir_for(asset)
        if adir is None:
            return False
        os.makedirs(adir, exist_ok=True)
        tmp = os.path.join(adir, "manifest.json.tmp")
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump(doc, fh, separators=(",", ":"))
            os.replace(tmp, os.path.join(adir, "manifest.json"))
        except OSError:
            return False
        with self._lock:
            self._manifests[_norm(asset)] = doc
        return True

    def meta_doc(self, asset: str) -> dict | None:
        """The asset's DVR meta/index document the manifest carries."""
        man = self.manifest(asset)
        if man is None:
            man = self._sync_manifest(asset)
        doc = (man or {}).get("dvr")
        return doc if isinstance(doc, dict) else None

    def _nodes(self) -> dict:
        if self.peer_nodes is None:
            return {}
        return dict(self.peer_nodes() or {})

    # --------------------------------------------------------------- store
    def store_asset(self, path: str, dvr) -> dict | None:
        """Shard one finalized asset (``DvrManager.on_finalize``): encode
        every track's windows into ``k + m`` stripes, keep the local
        shards, push the rest to their holders, queue a claim a shard.
        A failed push keeps the shard local."""
        t0 = time.perf_counter_ns()
        try:
            return self._store(path, dvr)
        finally:
            with self._lock:
                self.store_calls += 1
                self.store_ns += time.perf_counter_ns() - t0

    def _store(self, path: str, dvr) -> dict | None:
        key = _norm(path)
        doc = dvr.meta_doc(key)
        if doc is None or not isinstance(doc.get("tracks"), dict):
            return None
        adir = self._dir_for(key)
        if adir is None:
            return None
        nodes = self._nodes()
        ring_nodes = nodes if nodes else {self.node_id: {}}
        ring = (self.ring_for(ring_nodes) if self.ring_for is not None
                else None)
        try:
            gen = int((doc.get("meta") or {}).get("gen", 0))
        except (TypeError, ValueError):
            gen = 0
        # a fresh tree a generation: a re-recorded asset's stale shards
        # never mix with the new stripes
        if os.path.isdir(adir):
            shutil.rmtree(adir, ignore_errors=True)
        man = {"version": MANIFEST_VERSION, "path": key, "gen": gen,
               "k": self.k, "m": self.m, "tracks": {},
               "holders": {}, "dvr": doc}
        shards: list[tuple[str, int, bytes]] = []   # (name, idx, payload)
        for tid_s, idx_doc in doc["tracks"].items():
            try:
                tid = int(tid_s)
            except (TypeError, ValueError):
                continue
            wins = sorted(int(r["win"]) for r in
                          (idx_doc.get("windows") or ())
                          if isinstance(r, dict) and "win" in r)
            if not wins:
                continue
            trec = {"wins": wins, "stripes": []}
            for s in range(0, (len(wins) + self.k - 1) // self.k):
                grp = wins[s * self.k:(s + 1) * self.k]
                blobs = [dvr.window_blob(key, tid, w) or b"" for w in grp]
                blobs += [b""] * (self.k - len(blobs))
                parity = self.codec.parity(blobs)
                srec = {"lens": [len(b) for b in blobs],
                        "crcs": [zlib.crc32(b) & 0xFFFFFFFF
                                 for b in blobs],
                        "pcrcs": [zlib.crc32(p) & 0xFFFFFFFF
                                  for p in parity],
                        "width": max([len(b) for b in blobs] + [1])}
                trec["stripes"].append(srec)
                for j, b in enumerate(blobs):
                    if b:
                        shards.append((shard_name(tid, s, j), j, b))
                for p, pb in enumerate(parity):
                    shards.append(
                        (shard_name(tid, s, self.k + p), self.k + p, pb))
            man["tracks"][str(tid)] = trec
        if not shards:
            return None
        man_json = json.dumps(man, separators=(",", ":"))
        placed = {"data": 0, "parity": 0}
        for name, idx, payload in shards:
            target = self.node_id
            if ring is not None and len(ring_nodes) > 1:
                target = self._placement_target(ring, key, name)
            kind = "data" if idx < self.k else "parity"
            if target != self.node_id and self.push_shard is not None:
                try:
                    ok = bool(self.push_shard(
                        ring_nodes.get(target) or {}, key, name, payload,
                        man_json))
                except Exception:
                    traceback.print_exc(file=sys.stderr)
                    ok = False
                if not ok:
                    self.push_failures += 1
                    target = self.node_id       # keep it: never lose bytes
            if target == self.node_id:
                if not self._write_shard(key, name, payload):
                    continue
                with self._lock:
                    self.shards_local += 1
            else:
                self.shards_pushed += 1
            obs.STORAGE_SHARDS.inc(kind=kind)
            placed[kind] += 1
            man["holders"][name] = target
            self._queue_claim(key, name, target)
        self._write_manifest(key, man)
        self.stored_assets += 1
        obs.EVENTS.emit("storage.store", stream=key, asset=key,
                        shards=placed["data"] + placed["parity"],
                        parity=placed["parity"])
        return man

    def _write_shard(self, asset: str, name: str, payload: bytes) -> bool:
        p = self._shard_path(asset, name)
        if p is None:
            return False
        try:
            os.makedirs(os.path.dirname(p), exist_ok=True)
            tmp = p + ".tmp"
            with open(tmp, "wb") as fh:
                fh.write(payload)
            os.replace(tmp, p)
        except OSError:
            return False
        return True

    def _queue_claim(self, asset: str, name: str, holder: str) -> None:
        with self._lock:
            self._pending_claims.append(
                (shard_key(asset, name), {"node": holder}))

    def pending_claims(self) -> list[tuple[str, dict]]:
        """Drain the claim queue (a cluster tick writes these)."""
        with self._lock:
            out, self._pending_claims = self._pending_claims, []
        return out

    # ---------------------------------------------------------- peer faces
    def serve_shard(self, asset: str, name: str) -> bytes | None:
        """One local shard's payload, crc-verified against the manifest
        (corrupt bytes are counted and quarantined, never served)."""
        return self._read_local(asset, name)

    def receive_shard(self, asset: str, name: str, payload: bytes,
                      manifest_doc: dict | None) -> bool:
        """A pushed shard: adopt the manifest (a newer generation
        replaces the asset), crc-verify the payload against it, persist,
        queue our claim."""
        key = _norm(asset)
        if manifest_doc is not None:
            cur = self.manifest(key)
            try:
                new_gen = int(manifest_doc.get("gen", 0))
            except (TypeError, ValueError):
                return False
            if cur is None or int(cur.get("gen", -1)) != new_gen:
                adir = self._dir_for(key)
                if adir is not None and os.path.isdir(adir) \
                        and cur is not None \
                        and int(cur.get("gen", -1)) < new_gen:
                    shutil.rmtree(adir, ignore_errors=True)
                    with self._lock:
                        self._manifests.pop(key, None)
                if not self._write_manifest(key, manifest_doc):
                    return False
        man = self.manifest(key)
        if man is None:
            return False
        want = self._expected_crc(man, name)
        if want is None \
                or (zlib.crc32(payload) & 0xFFFFFFFF) != want:
            return False
        if not self._write_shard(key, name, payload):
            return False
        with self._lock:
            self.shards_local += 1
        self._queue_claim(key, name, self.node_id)
        return True

    @staticmethod
    def _parse_name(name: str) -> tuple[int, int, int] | None:
        try:
            tpart, spart = name.split("/", 1)
            tid = int(tpart[1:])
            stripe_s, idx_s = spart[1:].split(".", 1)
            return tid, int(stripe_s), int(idx_s)
        except (ValueError, IndexError):
            return None

    def _expected_crc(self, man: dict, name: str) -> int | None:
        parsed = self._parse_name(name)
        if parsed is None:
            return None
        tid, stripe, idx = parsed
        trec = (man.get("tracks") or {}).get(str(tid))
        if not isinstance(trec, dict):
            return None
        stripes = trec.get("stripes") or []
        if not 0 <= stripe < len(stripes):
            return None
        srec = stripes[stripe]
        try:
            if idx < int(man.get("k", self.k)):
                return int(srec["crcs"][idx])
            return int(srec["pcrcs"][idx - int(man.get("k", self.k))])
        except (KeyError, IndexError, TypeError, ValueError):
            return None

    def _read_local(self, asset: str, name: str) -> bytes | None:
        """Local shard bytes, crc-verified; a mismatch counts a scrub
        error, quarantines the file and queues repair."""
        p = self._shard_path(asset, name)
        if p is None or not os.path.isfile(p):
            return None
        try:
            with open(p, "rb") as fh:
                payload = fh.read()
        except OSError:
            return None
        man = self.manifest(asset)
        want = self._expected_crc(man, name) if man else None
        if want is not None \
                and (zlib.crc32(payload) & 0xFFFFFFFF) != want:
            self._note_corrupt(asset, name, p)
            return None
        return payload

    def _note_corrupt(self, asset: str, name: str, path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass
        obs.STORAGE_SCRUB_ERRORS.inc()
        obs.EVENTS.emit("storage.scrub_error", level="error",
                        stream=asset, asset=asset, shard=name)
        with self._lock:
            self.scrub_errors += 1
            if (asset, name) not in self._repair_inflight:
                self._repair_queue.append((_norm(asset), name))

    # -------------------------------------------------------------- restore
    def restore_window(self, path: str, track: int,
                       win: int) -> bytes | None:
        """The spill chain's last resort (blocking: a worker thread's
        job): the raw window blob from its local shard file, or a
        byte-exact reconstruct from ``k`` surviving shards of its stripe.
        None: beyond the parity budget (counted in
        ``reconstruct_failures``)."""
        key = _norm(path)
        man = self.manifest(key) or self._sync_manifest(key)
        if man is None:
            return None
        trec = (man.get("tracks") or {}).get(str(int(track)))
        if not isinstance(trec, dict):
            return None
        wins = trec.get("wins") or []
        try:
            pos = wins.index(int(win))
        except ValueError:
            return None
        k = int(man.get("k", self.k))
        s, j = divmod(pos, k)
        name = shard_name(int(track), s, j)
        # one gather and solve serves the whole stripe (the solved rows
        # and the survivors it read)
        ck = (key, int(track), s, int(man.get("gen", 0)))
        with self._lock:
            cached = self._stripe_cache.get(ck)
        if cached is not None and j in cached:
            with self._lock:
                self.reconstructs += 1
            return cached[j]
        local = self._read_local(key, name)
        if local is not None:
            return local
        try:
            srec = (trec.get("stripes") or [])[s]
            lens = [int(x) for x in srec["lens"]]
        except (IndexError, KeyError, TypeError, ValueError):
            return None
        t0 = time.perf_counter_ns()
        present = self._gather_stripe(key, man, int(track), s, lens,
                                      skip=j)
        with self._lock:
            self.gathers += 1
            self.gather_ns += time.perf_counter_ns() - t0
        try:
            out = self.codec.reconstruct(
                present, lens, asset=f"{key}/{name}",
                crcs=[int(x) for x in srec.get("crcs") or ()] or None)
        except StorageError:
            with self._lock:
                self.reconstruct_failures += 1
            traceback.print_exc(file=sys.stderr)
            return None
        entry = dict(out)
        for i, blob in present.items():
            if i < k:                   # survivors ride along
                entry[i] = blob
        with self._lock:
            self.reconstructs += 1
            while len(self._stripe_cache) >= self._stripe_cache_max:
                self._stripe_cache.pop(next(iter(self._stripe_cache)))
            self._stripe_cache[ck] = entry
        return out.get(j)

    def _gather_stripe(self, asset: str, man: dict, tid: int, s: int,
                       lens: list[int], *, skip: int) -> dict[int, bytes]:
        """Every shard of one stripe this node can reach: local files,
        then the manifest's holders, then the live peers.  Parity is
        fetched only as far as the missing data needs."""
        k, m = int(man.get("k", self.k)), int(man.get("m", self.m))
        present: dict[int, bytes] = {}
        nodes = self._nodes()
        holders = man.get("holders") or {}
        missing_data = 0
        for idx in range(k):
            if idx == skip and lens[idx] > 0:
                missing_data += 1
                continue                   # the one being rebuilt
            if idx < len(lens) and lens[idx] == 0:
                continue                   # tail padding: known zero
            payload = self._fetch_any(asset, shard_name(tid, s, idx),
                                      nodes, holders)
            if payload is not None:
                present[idx] = payload
            else:
                missing_data += 1
        got_parity = 0
        for p in range(m):
            if got_parity >= missing_data:
                break
            payload = self._fetch_any(asset, shard_name(tid, s, k + p),
                                      nodes, holders)
            if payload is not None:
                present[k + p] = payload
                got_parity += 1
        return present

    def _fetch_any(self, asset: str, name: str, nodes: dict,
                   holders: dict) -> bytes | None:
        local = self._read_local(asset, name)
        if local is not None:
            return local
        if self.fetch_shard is None:
            return None
        man = self.manifest(asset)
        order = []
        h = holders.get(name)
        if h and h in nodes and h != self.node_id:
            order.append(h)
        order += [n for n in nodes
                  if n != self.node_id and n not in order]
        for node in order:
            payload = self.fetch_shard(nodes.get(node) or {}, asset, name)
            if not payload:
                continue
            want = self._expected_crc(man, name) if man else None
            if want is not None \
                    and (zlib.crc32(payload) & 0xFFFFFFFF) != want:
                continue                   # corrupt peer copy
            return payload
        return None

    def _sync_manifest(self, asset: str) -> dict | None:
        """No local manifest: ask the live peers for one."""
        if self.fetch_manifest is None or self.peer_nodes is None:
            return None
        for node, meta in self._nodes().items():
            if node == self.node_id:
                continue
            doc = self.fetch_manifest(meta or {}, asset)
            if isinstance(doc, dict) \
                    and doc.get("version") == MANIFEST_VERSION:
                self._write_manifest(_norm(asset), doc)
                return doc
        return None

    # ----------------------------------------------------------- scrubbing
    def scrub_tick(self, *, batch: int | None = None) -> int:
        """Verify up to ``batch`` local shards against the manifest's
        crc32s; a parity shard whose stripe's data shards are all local
        is also re-derived through the host GF product.  A bad shard is
        counted, quarantined and queued for repair.  Returns the shards
        verified."""
        if self._closed:
            return 0
        n = batch or self.SCRUB_BATCH
        if not self._scrub_cursor:
            self._scrub_cursor = self._walk_shards()
        done = 0
        while self._scrub_cursor and done < n:
            asset, name = self._scrub_cursor.pop()
            man = self.manifest(asset)
            if man is None:
                continue
            payload = self._read_local(asset, name)   # counts crc errors
            done += 1
            self.scrubbed += 1
            if payload is None:
                continue
            parsed = self._parse_name(name)
            if parsed is None:
                continue
            tid, s, idx = parsed
            k = int(man.get("k", self.k))
            if idx < k:
                continue
            try:
                srec = man["tracks"][str(tid)]["stripes"][s]
                lens = [int(x) for x in srec["lens"]]
            except (KeyError, IndexError, TypeError, ValueError):
                continue
            blobs = []
            for j in range(k):
                if lens[j] == 0:
                    blobs.append(b"")
                    continue
                b = self._read_local(asset, shard_name(tid, s, j))
                if b is None:
                    blobs = None
                    break
                blobs.append(b)
            if blobs is None:
                continue
            width = max([len(b) for b in blobs] + [1])
            rows = np.zeros((k, width), np.uint8)
            for j, b in enumerate(blobs):
                if b:
                    rows[j, :len(b)] = np.frombuffer(b, np.uint8)
            host = gf_matmul(coeff_rows(range(k), idx - k + 1), rows)
            if host[idx - k, :len(payload)].tobytes() != payload:
                p = self._shard_path(asset, name)
                self._note_corrupt(asset, name, p or "")
        return done

    def _walk_shards(self) -> list[tuple[str, str]]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for f in files:
                if not f.startswith("s") or "." not in f:
                    continue
                full = os.path.join(dirpath, f)
                rel = os.path.relpath(full, self.root)
                parts = rel.split(os.sep)
                if len(parts) < 2 or not parts[-2].startswith("t"):
                    continue
                asset = "/" + "/".join(parts[:-2])
                out.append((asset, f"{parts[-2]}/{f}"))
        return out

    # -------------------------------------------------------------- repair
    def repair_scan(self, live_nodes: dict,
                    shard_records: dict[str, dict]) -> int:
        """Given the live nodes and the fenced ``Shard:`` records, queue
        the re-materialization of every shard whose holder is dead and
        whose new home on the survivors' ring is this node.  Returns the
        jobs queued."""
        if self._closed or not shard_records:
            return 0
        ring = (self.ring_for(live_nodes) if self.ring_for is not None
                else None)
        queued = 0
        for key, rec in shard_records.items():
            holder = rec.get("node") if isinstance(rec, dict) else None
            if holder in live_nodes:
                continue
            rel = key[len(SHARD_KEY_PREFIX):]
            asset, _, name = rel.rpartition("/t")
            if not asset or not name:
                continue
            asset, name = "/" + asset, "t" + name
            if ring is not None \
                    and self._placement_target(ring, asset, name) \
                    != self.node_id:
                continue
            p = self._shard_path(asset, name)
            if p is not None and os.path.isfile(p):
                self._queue_claim(asset, name, self.node_id)
                continue
            job = (_norm(asset), name)
            with self._lock:
                if job in self._repair_inflight:
                    continue
                self._repair_inflight.add(job)
            self._submit(self._repair_job, *job)
            queued += 1
        return queued

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                2, thread_name_prefix="storage")
        return self._pool

    def _submit(self, fn, *args):
        """Run ``fn`` on a worker; a job that raises is counted in
        ``worker_errors`` and its traceback goes to stderr."""
        fut = self._executor().submit(fn, *args)
        fut.add_done_callback(self._job_done)
        return fut

    def _job_done(self, fut) -> None:
        if fut.cancelled() or fut.exception() is None:
            return
        with self._lock:
            self.worker_errors += 1
        e = fut.exception()
        traceback.print_exception(type(e), e, e.__traceback__,
                                  file=sys.stderr)

    def store_async(self, path: str, dvr):
        """``store_asset`` on a worker (a finalize runs on the event
        loop; sharding is blocking)."""
        return self._submit(self.store_asset, path, dvr)

    def restore_async(self, path: str, track: int, win: int):
        """``restore_window`` on a worker (the spill read chain polls the
        future from the pump)."""
        return self._submit(self.restore_window, path, int(track),
                            int(win))

    def scrub_async(self):
        """``scrub_tick`` on a worker."""
        return self._submit(self.scrub_tick)

    def repair_now(self, asset: str, name: str) -> int | None:
        """Re-materialize one shard now.  Returns the bytes written, or
        None when the stripe cannot be repaired yet."""
        nbytes = self._repair_one(asset, name)
        if nbytes is None:
            return None
        with self._lock:
            self.repairs += 1
            self.repair_bytes += nbytes
        parsed = self._parse_name(name)
        kind = "parity" if parsed and parsed[2] >= self.k else "data"
        obs.STORAGE_REPAIRS.inc(kind=kind)
        obs.STORAGE_REPAIR_BYTES.inc(nbytes)
        obs.STORAGE_SHARDS.inc(kind=kind)
        obs.EVENTS.emit("storage.repair", stream=asset, asset=asset,
                        shards=1, shard=name)
        return nbytes

    def _repair_job(self, asset: str, name: str) -> None:
        try:
            self.repair_now(asset, name)
        except Exception:
            with self._lock:
                self.repair_errors += 1
            traceback.print_exc(file=sys.stderr)
        finally:
            with self._lock:
                self._repair_inflight.discard((asset, name))

    def _repair_one(self, asset: str, name: str) -> int | None:
        """A missing data shard is a reconstruct; a missing parity shard
        is the parity product re-run over the ``k`` data blobs."""
        man = self.manifest(asset) or self._sync_manifest(asset)
        if man is None:
            return None
        parsed = self._parse_name(name)
        if parsed is None:
            return None
        tid, s, idx = parsed
        k = int(man.get("k", self.k))
        try:
            srec = man["tracks"][str(tid)]["stripes"][s]
            lens = [int(x) for x in srec["lens"]]
        except (KeyError, IndexError, TypeError, ValueError):
            return None
        if idx < k:
            if lens[idx] == 0:
                return None                # tail padding: nothing to fix
            present = self._gather_stripe(asset, man, tid, s, lens,
                                          skip=idx)
            out = self.codec.reconstruct(
                present, lens, asset=f"{asset}/{name}",
                crcs=[int(x) for x in srec.get("crcs") or ()] or None)
            with self._lock:
                self.reconstructs += 1
            payload = out.get(idx)
        else:
            nodes = self._nodes()
            blobs = []
            for j in range(k):
                if lens[j] == 0:
                    blobs.append(b"")
                    continue
                b = self._fetch_any(asset, shard_name(tid, s, j), nodes,
                                    man.get("holders") or {})
                if b is None:
                    return None            # data gone too: repair later
                blobs.append(b)
            payload = self.codec.parity(blobs)[idx - k]
        if not payload:
            return None
        if not self._write_shard(asset, name, payload):
            return None
        with self._lock:
            self.shards_local += 1
        self._queue_claim(asset, name, self.node_id)
        return len(payload)

    # ----------------------------------------------------------------- misc
    def stats(self) -> dict:
        c = self.codec
        rec = max(self.gathers, 1)
        return {
            "assets": self.stored_assets,
            "shards_local": self.shards_local,
            "shards_pushed": self.shards_pushed,
            "push_failures": self.push_failures,
            "reconstructs": self.reconstructs,
            "reconstruct_failures": self.reconstruct_failures,
            "repairs": self.repairs,
            "repair_bytes": self.repair_bytes,
            "repair_errors": self.repair_errors,
            "scrub_errors": self.scrub_errors,
            "scrubbed": self.scrubbed,
            "worker_errors": self.worker_errors,
            "oracle_mismatches": c.oracle_mismatches,
            "device_passes": c.device_passes,
            "host_products": c.host_products,
            "store_calls": self.store_calls,
            "store_ms_per_call": self.store_ns / max(self.store_calls, 1)
            / 1e6,
            "gathers": self.gathers,
            "gather_ms_per_reconstruct": self.gather_ns / rec / 1e6,
            "product_ms_per_reconstruct":
                c.product_ns["reconstruct"] / rec / 1e6,
            "check_ms_per_reconstruct":
                c.check_ns["reconstruct"] / rec / 1e6,
            "parity_product_ms": c.product_ns["parity"] / 1e6,
            "parity_check_ms": c.check_ns["parity"] / 1e6,
        }

    def close(self) -> None:
        """Stop taking work and wait for the jobs in flight (a store of
        the last finalized asset among them)."""
        self._closed = True
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = None


__all__ = ["StorageService", "SHARD_KEY_PREFIX", "shard_key",
           "shard_name", "MANIFEST_VERSION"]
