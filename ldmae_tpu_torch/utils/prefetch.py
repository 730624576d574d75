"""Background-thread batch prefetcher (port of ``ldmae_tpu/utils/prefetch.py``).

The CLIs' stand-in for DataLoader workers: one thread runs the batch
iterator ``buffer_size`` batches ahead of the loop, so shard reads, PNG
decodes, augmentation and the host-to-device copy overlap the device work.
An exception on the thread is raised in the consumer when it reaches it.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator


class Prefetcher:
    """Wrap an iterator; pull its items on a background (daemon) thread."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator[Any], buffer_size: int = 4):
        self._it = iterator
        self._q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
        self._err = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for item in self._it:
                self._q.put(item)
        except Exception as e:  # raised in the consumer thread
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
