"""Early stopping: a host-side state machine (the port's own copy).

The counter grows on a stall (improvement below min_delta) or a rise
(worse by more than min_delta); any other outcome resets it and records
the new best. Stops when the counter reaches ``tolerance``.
"""

from __future__ import annotations

import math


class EarlyStopping:
    def __init__(self, tolerance: int = 5, min_delta: float = 0.0):
        self.tolerance = tolerance
        self.min_delta = min_delta
        self.best_loss = math.inf
        self.counter = 0
        self.early_stop = False

    def __call__(self, loss: float) -> None:
        if abs(self.best_loss - loss) < self.min_delta and loss < self.best_loss:
            self.counter += 1
        elif abs(self.best_loss - loss) > self.min_delta and loss > self.best_loss:
            self.counter += 1
        else:
            self.counter = 0
            self.best_loss = loss
        if self.counter >= self.tolerance:
            self.early_stop = True
