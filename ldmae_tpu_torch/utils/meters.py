"""Training meters (port of ``ldmae_tpu/utils/meters.py``).

The reference's logging stack (``VMAE/util/misc.py``): ``SmoothedValue``
(windowed median and mean, and the global mean), ``MetricLogger`` (named
meters and periodic log lines) and ``all_reduce_mean``, the mean of a host
scalar over the ranks, here through ``torch.distributed`` (the gloo group
of ``parallel.distributed``).
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Dict, Iterable

import numpy as np

from ..parallel.distributed import all_reduce_sum, get_world_size


class SmoothedValue:
    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque: deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1) -> None:
        self.deque.append(value)
        self.count += n
        self.total += value * n

    @property
    def median(self) -> float:
        return float(np.median(self.deque)) if self.deque else 0.0

    @property
    def avg(self) -> float:
        return float(np.mean(self.deque)) if self.deque else 0.0

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def max(self) -> float:
        return float(np.max(self.deque)) if self.deque else 0.0

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self) -> str:
        return self.fmt.format(median=self.median, avg=self.avg, global_avg=self.global_avg, max=self.max,
                               value=self.value)


def all_reduce_mean(value: float) -> float:
    """The mean of a host scalar over the ranks (``misc.py:534-542``); the
    value itself for one process."""
    if get_world_size() == 1:
        return float(value)
    return float(all_reduce_sum(np.array([value], np.float64))[0]) / get_world_size()


class MetricLogger:
    def __init__(self, delimiter: str = "  "):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter

    def update(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.meters[k].update(float(v))

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self) -> str:
        return self.delimiter.join(f"{n}: {m}" for n, m in self.meters.items())

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        """Timed iteration with a log line every ``print_freq`` items."""
        i = 0
        start = end = time.time()
        iter_time, data_time = SmoothedValue(fmt="{avg:.4f}"), SmoothedValue(fmt="{avg:.4f}")
        for obj in iterable:
            data_time.update(time.time() - end)
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                print(f"{header} [{i}]  {self}  time: {iter_time}  data: {data_time}")
            i += 1
            end = time.time()
        total = time.time() - start
        print(f"{header} Total time: {total:.1f}s ({total / max(i, 1):.4f} s/it)")
