"""Multi-stream trigger-time synchronizer — exact behavioral twin of the
reference's SyncBlock (blocks/basic SyncBlock.hpp:12-385).

Aligns N equal-rate streams on trigger tags whose ``trigger_time`` values
agree within ``tolerance`` ns: leading samples of ports that are ahead are
dropped (accounted via ``n_dropped_samples`` tags), synchronized spans stream
through, and when streams drift apart the per-port history is bounded by
``max_history_size`` (back-pressure drops) until the next common sync point.

Placement: alignment decisions are O(tags) host control-plane work
over buffered windows, exactly like the reference's processBulk over its
input spans (SyncBlock.hpp:167-230) — the device-side skew-bounded form lives
in ``blocks.misc.SyncBlock``. Feed each port incrementally (scheduler chunks)
and call :meth:`pump`; outputs accumulate per port with output-indexed tags.
"""

from __future__ import annotations

import numpy as np

from .tags import Keys, Tag

_NO_TIME = object()


def _is_sync_tag(tag: Tag, filter_name: str) -> bool:
    # ≈ SyncBlock.hpp:341 isSyncTag: trigger_name (matching the filter when
    # set) AND an integer trigger_time
    if Keys.TRIGGER_NAME not in tag.map:
        return False
    if filter_name and str(tag.map[Keys.TRIGGER_NAME]) != filter_name:
        return False
    t = tag.map.get(Keys.TRIGGER_TIME)
    return isinstance(t, (int, np.integer)) and not isinstance(t, bool)


class SyncEngine:
    def __init__(self, n_ports: int, *, max_history_size: int = 32000,
                 filter: str = "", tolerance: int = 5):
        self.n = int(n_ports)
        self.max_history = int(max_history_size)
        self.filter = str(filter)
        self.tolerance = int(tolerance)
        self._bufs: list[list[np.ndarray]] = [[] for _ in range(self.n)]
        self._buf_n = [0] * self.n
        self._tags: list[list[Tag]] = [[] for _ in range(self.n)]
        self._is_sync = False
        self._dropped = [0] * self.n
        self.out: list[list[np.ndarray]] = [[] for _ in range(self.n)]
        self.out_n = [0] * self.n
        self.out_tags: list[list[Tag]] = [[] for _ in range(self.n)]

    # -- feeding ------------------------------------------------------------------

    def feed(self, port: int, data: np.ndarray, tags: list[Tag] = (), *,
             pump: bool = True) -> None:
        """Append a chunk (tags chunk-relative), then :meth:`pump`.

        When feeding several ports for the same time quantum, pass
        ``pump=False`` for all and call :meth:`pump` once afterwards — the
        reference processBulk sees every port's span in ONE call, and pumping
        between per-port appends would back-pressure-drop one port's history
        before its peers' sync tags arrive."""
        data = np.asarray(data)
        if data.shape[-1]:
            self._tags[port] += [t.shifted(self._buf_n[port]) for t in tags]
            self._bufs[port].append(data)
            self._buf_n[port] += data.shape[-1]
        if pump:
            self.pump()

    def data(self, port: int) -> np.ndarray:
        if not self.out[port]:
            return np.zeros(0)
        return np.concatenate(self.out[port], axis=-1)

    # -- internals ------------------------------------------------------------------

    def _buffer(self, port: int) -> np.ndarray:
        if len(self._bufs[port]) > 1:
            self._bufs[port] = [np.concatenate(self._bufs[port], axis=-1)]
        return self._bufs[port][0] if self._bufs[port] else np.zeros(0)

    def _consume(self, port: int, n: int) -> None:
        if n <= 0:
            return
        buf = self._buffer(port)
        rest = buf[..., n:]
        self._bufs[port] = [rest] if rest.shape[-1] else []
        self._buf_n[port] = rest.shape[-1]
        # ≈ consumeTags(n): tags before the consume point go away
        self._tags[port] = [t.shifted(-n) for t in self._tags[port]
                            if t.index >= n]

    def _publish(self, port: int, data: np.ndarray) -> None:
        if data.shape[-1]:
            self.out[port].append(np.array(data))
            self.out_n[port] += data.shape[-1]

    def _publish_tag(self, port: int, rel: int, tmap: dict) -> None:
        self.out_tags[port].append(Tag(self.out_n[port] + rel, dict(tmap)))

    def _within(self, t1: int, t2: int) -> bool:
        return abs(int(t1) - int(t2)) < self.tolerance

    def _find_sync_time(self):
        """≈ SyncBlock.hpp:277 findSyncTime: earliest time present (within
        tolerance) on every port."""
        per_port: list[list[int]] = []
        all_times: set[int] = set()
        for p in range(self.n):
            times = [int(t.map[Keys.TRIGGER_TIME]) for t in self._tags[p]
                     if _is_sync_tag(t, self.filter)
                     and t.index < self._buf_n[p]]
            per_port.append(times)
            all_times.update(times)
        for cur in sorted(all_times):
            if all(any(self._within(cur, t) for t in times)
                   for times in per_port):
                return cur
        return _NO_TIME

    def _sync_data(self):
        """≈ hpp:253 synchronize → per-port (index, nPre, nPost) or None."""
        sync_time = self._find_sync_time()
        if sync_time is _NO_TIME:
            return None
        out = []
        for p in range(self.n):
            entry = None
            for t in self._tags[p]:
                if _is_sync_tag(t, self.filter) and t.index < self._buf_n[p] \
                        and self._within(int(t.map[Keys.TRIGGER_TIME]),
                                         sync_time):
                    idx = t.index
                    # nPre: up to the FIRST earlier sync tag (hpp:305 find_if
                    # scans in tag order, not closest-first)
                    pre = idx
                    for u in self._tags[p]:
                        if u.index < idx and _is_sync_tag(u, self.filter):
                            pre = idx - u.index - 1
                            break
                    post = self._buf_n[p] - idx - 1
                    for u in self._tags[p]:
                        if idx < u.index < self._buf_n[p] \
                                and _is_sync_tag(u, self.filter):
                            post = u.index - idx - 1
                            break
                    entry = (idx, pre, post)
                    break
            if entry is None:
                return None
            out.append(entry)
        return out

    def _n_before_sync_tag(self, port: int) -> int:
        for t in self._tags[port]:
            if _is_sync_tag(t, self.filter):
                return min(t.index, self._buf_n[port])
        return self._buf_n[port]

    def _publish_input_tags(self, port: int, drop: int, n_publish: int
                            ) -> None:
        # ≈ hpp:245 publishInputTags
        for t in self._tags[port]:
            if drop <= t.index < drop + n_publish:
                self._publish_tag(port, t.index - drop, t.map)

    def pump(self) -> None:
        while self._pump_once():
            pass

    def _pump_once(self) -> bool:
        """One processBulk pass (hpp:167-230); host-side there is no output
        backpressure, so minSamplesOut is unbounded."""
        sync = self._sync_data()
        if sync is not None:
            min_pre = min(s[1] for s in sync)
            min_post = min(s[2] for s in sync)
            n_publish = min_pre + 1 + min_post
            for p in range(self.n):
                idx, _, _ = sync[p]
                drop = idx - min_pre
                buf = self._buffer(p)
                total_dropped = self._dropped[p] + drop
                if total_dropped > 0:
                    self._publish_tag(p, 0, {Keys.N_DROPPED_SAMPLES:
                                             int(total_dropped)})
                self._publish_input_tags(p, drop, n_publish)
                self._publish(p, buf[..., drop:drop + n_publish])
                self._dropped[p] = 0
                self._consume(p, drop + n_publish)
            self._is_sync = True
            return True

        min_before = min(self._n_before_sync_tag(p) for p in range(self.n))
        if self._is_sync and min_before > 0:
            # all streams in sync → stream through up to the next sync tag
            for p in range(self.n):
                if self._dropped[p] > 0:
                    self._publish_tag(p, 0, {Keys.N_DROPPED_SAMPLES:
                                             int(self._dropped[p])})
                    self._dropped[p] = 0
                self._publish_input_tags(p, 0, min_before)
                self._publish(p, self._buffer(p)[..., :min_before])
                self._consume(p, min_before)
            return True

        # not in sync → bound the history (back-pressure drops, hpp:211-223)
        progressed = False
        for p in range(self.n):
            n_drop = max(0, self._buf_n[p] - self.max_history)
            if n_drop:
                self._consume(p, n_drop)
                self._dropped[p] += n_drop
                self._is_sync = False
                progressed = True
        return progressed
