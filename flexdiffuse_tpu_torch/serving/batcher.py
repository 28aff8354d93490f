"""Dynamic micro-batching for the serving API (port of
``flexdiffuse_tpu/serving/batcher.py``; pure Python, the same semantics).

Batch size is the card's throughput lever: one denoise loop over B rows
runs each UNet evaluation at batch 2B instead of B separate loops at batch
2. Interactive requests arrive one at a time, so the serving path puts a
micro-batcher in front of the device:

* requests enqueue with a **group key** (the facts that must agree for
  rows to share one denoise loop: steps, size, CFG on/off) and a row
  count;
* a single dispatcher thread drains the queue — it collects same-group
  requests until ``max_batch_rows`` or ``max_wait_ms`` elapses, then runs
  the whole group as ONE batched pipeline call and distributes
  per-request results through futures;
* batch row counts quantize up to powers of two (``pad_rows``) so the
  device sees a handful of batch shapes whatever the arrival pattern —
  padding rows replicate the last request's rows and are dropped on the
  way out;
* ``fixed_rows=True`` pads every dispatch to ``max_batch_rows`` instead:
  one batch shape for the group, so a request's result is the same bits
  whatever it was batched with (kernels and libraries may pick another
  algorithm, and so another summation order, for another batch shape).
  The default power-of-two padding keeps singleton latency low and
  guarantees identical results only for identical padded shapes.

One dispatcher thread == one device queue: requests never race for the
card, and only that thread runs the model (HTTP threads only wait on
futures).
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, List, Optional, Sequence

log = logging.getLogger(__name__)


@dataclass
class _Item:
    payload: Any
    rows: int
    group: Hashable
    future: Future = field(default_factory=Future)
    enqueued: float = field(default_factory=time.monotonic)


def pad_rows(n: int, max_rows: int) -> int:
    """Quantize a row count up to the next power of two (≤ max_rows) so
    compiled batch shapes stay few and reusable."""
    p = 1
    while p < n:
        p *= 2
    return min(p, max_rows)


class MicroBatcher:
    """``submit(payload, rows, group) -> Future`` over a run_batch callable.

    ``run_batch(payloads, total_rows) -> list_of_per_payload_results`` runs
    one fused device call for a same-group batch; it must return one result
    per payload (the batcher handles padding bookkeeping — ``total_rows``
    is the padded row count the device program should use).
    """

    def __init__(self, run_batch: Callable[[List[Any], int], Sequence[Any]],
                 max_batch_rows: int = 8, max_wait_ms: float = 30.0,
                 fixed_rows: bool = False, name: str = 'batcher'):
        self._run = run_batch
        self.max_batch_rows = max_batch_rows
        self.max_wait_ms = max_wait_ms
        self.fixed_rows = fixed_rows
        self._q: 'queue.Queue[Optional[_Item]]' = queue.Queue()
        self._held: List[_Item] = []   # incompatible items awaiting turn
        self._stats = {'requests': 0, 'batches': 0, 'rows': 0,
                       'padded_rows': 0}
        self._stats_lock = threading.Lock()
        self._stop = False
        self._thread = threading.Thread(target=self._loop, name=name,
                                        daemon=True)
        self._thread.start()

    # -- public ----------------------------------------------------------
    def submit(self, payload: Any, rows: int = 1,
               group: Hashable = None) -> Future:
        if rows < 1 or rows > self.max_batch_rows:
            raise ValueError(
                f'rows must be in [1, {self.max_batch_rows}], got {rows}')
        item = _Item(payload, rows, group)
        with self._stats_lock:
            self._stats['requests'] += 1
        self._q.put(item)
        return item.future

    def stats(self) -> dict:
        with self._stats_lock:
            s = dict(self._stats)
        s['mean_rows_per_batch'] = (s['rows'] / s['batches']
                                    if s['batches'] else 0.0)
        return s

    def shutdown(self) -> None:
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout=5)

    # -- dispatcher ------------------------------------------------------
    def _take(self, timeout: Optional[float]) -> Optional[_Item]:
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def _loop(self) -> None:
        while not self._stop:
            first = self._held.pop(0) if self._held else self._take(None)
            if first is None:
                continue
            batch = [first]
            rows = first.rows
            deadline = first.enqueued + self.max_wait_ms / 1e3
            while rows < self.max_batch_rows:
                # Prefer compatible held items (they arrived earlier).
                took = None
                for i, h in enumerate(self._held):
                    if h.group == first.group and \
                            rows + h.rows <= self.max_batch_rows:
                        took = self._held.pop(i)
                        break
                if took is None:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        break
                    nxt = self._take(wait)
                    if nxt is None:
                        break
                    if nxt.group != first.group or \
                            rows + nxt.rows > self.max_batch_rows:
                        self._held.append(nxt)
                        continue
                    took = nxt
                batch.append(took)
                rows += took.rows
            self._dispatch(batch, rows)

    def _dispatch(self, batch: List[_Item], rows: int) -> None:
        padded = (self.max_batch_rows if self.fixed_rows
                  else pad_rows(rows, self.max_batch_rows))
        with self._stats_lock:
            self._stats['batches'] += 1
            self._stats['rows'] += rows
            self._stats['padded_rows'] += padded - rows
        try:
            results = self._run([b.payload for b in batch], padded)
        except Exception as e:  # one bad batch must not kill the thread
            log.exception('batch of %d failed', len(batch))
            for b in batch:
                b.future.set_exception(e)
            return
        if len(results) != len(batch):
            err = RuntimeError(
                f'run_batch returned {len(results)} results for '
                f'{len(batch)} payloads')
            for b in batch:
                b.future.set_exception(err)
            return
        for b, r in zip(batch, results):
            b.future.set_result(r)
