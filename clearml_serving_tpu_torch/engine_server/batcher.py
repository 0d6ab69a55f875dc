"""Dynamic request batcher: the Triton ``dynamic_batching`` equivalent.

The port's copy of ``clearml_serving_tpu/engine_server/batcher.py``, with
the same knobs, carry rule, idle shutdown, counters and hooks. Requests for
one model queue up; a batch fires when it reaches ``preferred_batch_size``
or the oldest request has waited ``max_queue_delay_us``. The batch is
concatenated on the leading axis, run once (the model pads it to its
bucket) and split back.

Two changes:

- the batch runs on ``executor`` when one is given, else on a thread of the
  default executor as in the reference (``asyncio.to_thread``). A served
  model passes its own step thread (``device.lease_step_worker``): cuBLAS
  keeps a 32 MiB workspace per thread that uses it, for the life of the
  process, so the default executor's threads would each keep one;
- ``wait_idle()`` returns once no request is queued, waiting or running,
  so a retired model can drop its graphs after its last batch.
"""

from __future__ import annotations

import asyncio
import time
from typing import Callable, List, Optional, Tuple

import numpy as np


class DynamicBatcher:
    def __init__(
        self,
        run_batch: Callable[[List[np.ndarray]], List[np.ndarray]],
        preferred_batch_size: int = 8,
        max_queue_delay_us: int = 2000,
        max_batch_size: int = 64,
        bucket_for: Optional[Callable[[int], int]] = None,
        executor=None,
    ):
        self._run_batch = run_batch  # takes list of input arrays (batch-concat'd)
        self.preferred = int(preferred_batch_size)
        self.max_delay_s = float(max_queue_delay_us) / 1e6
        self.max_batch = int(max_batch_size)
        # rows -> executed bucket rows (repo.CompiledModel's bucket set): the
        # padding waste of the path the batcher feeds
        self.bucket_for = bucket_for
        self._executor = executor
        # items: (inputs, future, rows, enqueue_time)
        self._queue: "asyncio.Queue[Tuple[List[np.ndarray], asyncio.Future, int, float]]" = (
            asyncio.Queue()
        )
        self._task: Optional[asyncio.Task] = None
        # the loop the batches run from (None until the first request)
        self.loop: Optional[asyncio.AbstractEventLoop] = None
        self._waiting = 0      # requests whose futures are not resolved
        # a batch being collected or run, and an item deferred to the next
        # batch: neither is in the queue
        self._busy = False
        self._carry = None
        # observability
        self.batches_executed = 0
        self.requests_served = 0
        self.batch_size_sum = 0
        # rows the bucket padding executed beyond the real request rows
        self.padded_rows_sum = 0
        # queue-time hook (enqueue -> batch execution start), feeding the
        # engine server's queue-delay histogram
        self.on_queue_delay = None  # optional callable(seconds)
        # padding hook: callable(real_rows, padded_rows) per executed batch
        self.on_padding = None

    async def infer(self, inputs: List[np.ndarray]) -> List[np.ndarray]:
        """Submit one request's input list; rows = inputs[i].shape[0]."""
        rows = int(inputs[0].shape[0]) if inputs and inputs[0].ndim > 0 else 1
        if rows > self.max_batch:
            raise ValueError(
                "request batch {} exceeds max_batch_size {}".format(rows, self.max_batch)
            )
        future: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiting += 1
        try:
            await self._queue.put((inputs, future, rows, time.monotonic()))
            self._ensure_task()
            return await future
        finally:
            self._waiting -= 1

    def _ensure_task(self) -> None:
        if self._task is None or self._task.done():
            self.loop = asyncio.get_running_loop()
            self._task = self.loop.create_task(self._loop())

    def idle(self) -> bool:
        return (not self._waiting and not self._busy and self._carry is None
                and self._queue.empty())

    async def wait_idle(self, poll_s: float = 0.002) -> None:
        """Return once nothing is queued, waiting or executing."""
        while not self.idle():
            await asyncio.sleep(poll_s)

    async def _loop(self) -> None:
        while True:
            if self._carry is not None:
                # an item popped but deferred to this batch (row cap)
                first, self._carry = self._carry, None
            else:
                try:
                    first = await asyncio.wait_for(self._queue.get(), timeout=5.0)
                except asyncio.TimeoutError:
                    # idle shutdown without stranding: no awaits between the
                    # emptiness check and clearing _task, so any infer()
                    # either enqueued before this check or will see _task
                    # None and start a fresh task
                    if self._queue.empty():
                        self._task = None
                        return
                    continue
            self._busy = True
            batch = [first]
            total_rows = first[2]
            deadline = time.monotonic() + self.max_delay_s
            while total_rows < self.preferred:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    item = await asyncio.wait_for(self._queue.get(), timeout=timeout)
                except asyncio.TimeoutError:
                    break
                if total_rows + item[2] > self.max_batch:
                    self._carry = item  # keep the row cap honest; execute next round
                    break
                batch.append(item)
                total_rows += item[2]
                if total_rows >= self.preferred:
                    break
            await self._execute(batch)

    async def _run(self, concat: List[np.ndarray]) -> List[np.ndarray]:
        if self._executor is None:
            return await asyncio.to_thread(self._run_batch, concat)
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, self._run_batch, concat)

    async def _execute(self, batch) -> None:
        inputs_list = [b[0] for b in batch]
        futures = [b[1] for b in batch]
        rows = [b[2] for b in batch]
        if self.on_queue_delay is not None:
            now = time.monotonic()
            for b in batch:
                self.on_queue_delay(now - b[3])
        try:
            n_inputs = len(inputs_list[0])
            concat = [
                np.concatenate([req[i] for req in inputs_list], axis=0)
                for i in range(n_inputs)
            ]
            outputs = await self._run(concat)
            self.batches_executed += 1
            self.requests_served += len(batch)
            total_rows = sum(rows)
            self.batch_size_sum += total_rows
            padded = 0
            if self.bucket_for is not None:
                padded = max(0, int(self.bucket_for(total_rows)) - total_rows)
            self.padded_rows_sum += padded
            if self.on_padding is not None:
                self.on_padding(total_rows, padded)
            # split each output back per request along the leading axis
            offset = 0
            for fut, n in zip(futures, rows):
                per_request = [out[offset: offset + n] for out in outputs]
                if not fut.done():
                    fut.set_result(per_request)
                offset += n
        except Exception as ex:
            for fut in futures:
                if not fut.done():
                    fut.set_exception(ex)
        finally:
            self._busy = False
