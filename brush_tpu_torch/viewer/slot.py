"""Latest-wins, frame-indexed splat snapshots (port of
`brush_tpu/viewer/slot.py`, a copy holding the port's `Splats`).

Counterpart of brush-process/src/slot.rs: the trainer (or a ply stream)
publishes splat snapshots per frame index; a viewer reads the latest without
blocking the producer. Animations are just multiple frame indices
(brush-process/src/lib.rs:178-227).

A snapshot is a `Splats` the slot does not copy. `train_process` publishes
a copy of its splats, since its graphed step on the card writes into the
state's own tensors, so a published snapshot stays as it was while
training goes on (tests/test_torch_viewer.py holds that)."""

from __future__ import annotations

import threading
from typing import Optional

from brush_tpu_torch.models.splats import Splats


class Slot:
    def __init__(self):
        self._lock = threading.Lock()
        self._frames: dict[int, Splats] = {}
        self._version = 0
        # Optional dataset context, set by train_process when training with
        # a live viewer: scene_views is a list of dicts
        # {name, split, position, rotation, fov_x, fov_y}; gt_fn(i, max_dim)
        # returns the i-th view's ground-truth image as [H, W, 3|4] u8.
        # Powers the viewer's nearest-view snapping and training-view
        # compare (reference: apps/brush-app scene.rs, SURVEY Appendix F).
        self.scene_views: list = []
        self.gt_fn = None

    def set(self, frame: int, splats: Splats) -> None:
        with self._lock:
            self._frames[frame] = splats
            self._version += 1

    def get(self, frame: int = 0) -> Optional[Splats]:
        with self._lock:
            if frame in self._frames:
                return self._frames[frame]
            return self._frames.get(max(self._frames)) if self._frames else None

    @property
    def n_frames(self) -> int:
        with self._lock:
            return len(self._frames)

    @property
    def version(self) -> int:
        with self._lock:
            return self._version


class MessageBus:
    """Fan-out of training messages to any number of live subscribers.

    Counterpart of the reference's ProcessMessage stream consumed by the
    GUI/JS layers (brush-process/src/message.rs): the trainer publishes
    dicts; each subscriber owns a bounded queue (latest messages win when
    a slow consumer falls behind)."""

    def __init__(self, maxsize: int = 256):
        self._lock = threading.Lock()
        self._subs: list = []
        self._maxsize = maxsize

    def publish(self, message: dict) -> None:
        import queue
        with self._lock:
            subs = list(self._subs)
        for q in subs:
            try:
                q.put_nowait(message)
            except queue.Full:
                try:  # drop the oldest, keep the stream moving
                    q.get_nowait()
                    q.put_nowait(message)
                except queue.Empty:
                    pass

    def subscribe(self):
        import queue
        q = queue.Queue(maxsize=self._maxsize)
        with self._lock:
            self._subs.append(q)
        return q

    def unsubscribe(self, q) -> None:
        with self._lock:
            if q in self._subs:
                self._subs.remove(q)
