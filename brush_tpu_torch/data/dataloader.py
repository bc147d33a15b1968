"""Threaded scene loader with prefetch (port of
`brush_tpu/data/dataloader.py`).

Counterpart of brush-dataset/src/scene_loader.rs (N actor threads, shuffled
epochs, a bounded prefetch channel, and a byte-budgeted packed-batch cache):
Python threads + a Queue. Decode overlaps device compute exactly like the
reference's actor pipeline overlaps the train loop (SURVEY.md §2.5.3)."""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from brush_tpu_torch.data.scene import AlphaMode, Scene, load_image, pack_rgba


class LoadedView:
    __slots__ = ("gt_packed", "camera", "has_alpha", "img_size", "view_index")

    def __init__(self, gt_packed, camera, has_alpha, img_size, view_index):
        self.gt_packed = gt_packed
        self.camera = camera
        self.has_alpha = has_alpha
        self.img_size = img_size
        self.view_index = view_index


class SceneLoader:
    """Infinite shuffled stream of packed training views.

    `cache_bytes` bounds an in-memory packed-GT cache (the reference's
    6 GiB default, dataset/config.rs:8) — packed u32 GT is small enough
    that most datasets cache fully after the first epoch."""

    def __init__(self, scene: Scene, seed: int = 0, n_threads: int = 2,
                 prefetch: int = 4, alpha_mode: AlphaMode = AlphaMode.TRANSPARENT,
                 cache_bytes: int = 6 << 30):
        self.scene = scene
        self.alpha_mode = alpha_mode
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._index_queue: queue.Queue = queue.Queue()
        self._rng = np.random.default_rng(seed)
        self._stop = threading.Event()
        self._cache: dict[int, LoadedView] = {}
        self._cache_bytes = 0
        self._cache_budget = cache_bytes
        self._lock = threading.Lock()

        # Workers must exist before the feeder runs: _feed reads
        # len(self._workers), and a feeder that dies on the race leaves
        # every consumer blocked on an empty queue forever.
        self._workers = [
            threading.Thread(target=self._work, daemon=True)
            for _ in range(max(1, n_threads))
        ]
        self._feeder = threading.Thread(target=self._feed, daemon=True)
        self._feeder.start()
        for w in self._workers:
            w.start()

    def _feed(self):
        while not self._stop.is_set():
            order = self._rng.permutation(len(self.scene.views))
            for i in order:
                if self._stop.is_set():
                    return
                self._index_queue.put(int(i))
                # Keep the index queue shallow so shuffling stays fresh.
                while self._index_queue.qsize() > 2 * len(self._workers) + 2:
                    if self._stop.is_set():
                        return
                    threading.Event().wait(0.005)

    def load_view(self, i: int) -> LoadedView:
        with self._lock:
            if i in self._cache:
                return self._cache[i]
        view = self.scene.views[i]
        arr, has_alpha = load_image(
            self.scene.vfs, view.image_path, self.scene.max_resolution,
            mask_path=view.mask_path, subscale=self.scene.subscale)
        packed = pack_rgba(arr, self.alpha_mode)
        loaded = LoadedView(packed, view.camera, has_alpha,
                            (packed.shape[1], packed.shape[0]), i)
        with self._lock:
            if self._cache_bytes + packed.nbytes <= self._cache_budget:
                self._cache[i] = loaded
                self._cache_bytes += packed.nbytes
        return loaded

    def _work(self):
        while not self._stop.is_set():
            try:
                i = self._index_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                loaded = self.load_view(i)
            except Exception as e:  # surface decode errors to the consumer
                loaded = e
            while not self._stop.is_set():
                try:
                    self._queue.put(loaded, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[LoadedView]:
        return self

    def __next__(self) -> LoadedView:
        while True:
            try:
                item = self._queue.get(timeout=5.0)
                break
            except queue.Empty:
                if self._stop.is_set() or not self._feeder.is_alive():
                    raise RuntimeError(
                        "SceneLoader pipeline died (feeder stopped)") from None
        if isinstance(item, Exception):
            raise item
        return item

    def empty(self) -> bool:
        """Whether no view is ready (`next` would wait for a decode)."""
        return self._queue.empty()

    def stop(self):
        self._stop.set()
