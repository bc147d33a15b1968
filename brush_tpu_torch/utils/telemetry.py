"""Training telemetry: stats stream + image dumps (port of
`brush_tpu/utils/telemetry.py`).

Counterpart of brush-rerun (crates/brush-rerun/src/visualize_tools.rs):
telemetry writes a JSONL stats stream plus snapshots (eval renders as PNG,
splat histograms as npz) to a run directory, consumable by any dashboard
and by `utils/report.py`. The TrainMessage stream (process.py) remains
the typed in-process channel (message.rs:8-68). Pillow is imported only
where an image is written.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


class TelemetryLogger:
    def __init__(self, log_dir: str | Path):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "stats.jsonl", "a")
        self._t0 = time.time()

    def log_scalars(self, step: int, **scalars) -> None:
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if v is not None else None)
                    for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def log_image(self, step: int, name: str, img) -> None:
        """img: [H,W,3|4] float in [0,1] or uint8 (array or tensor)."""
        from PIL import Image
        img = _host(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        Image.fromarray(img).save(self.dir / f"{name}_{step:06d}.png")

    def log_splat_distribution(self, step: int, splats) -> None:
        """Histogram snapshots of splat stats (visualize_tools.rs splat
        distribution logging)."""
        n = int(splats.n_alive)
        np.savez(
            self.dir / f"splat_dist_{step:06d}.npz",
            log_scales=_host(splats.log_scales[:n]),
            raw_opacities=_host(splats.raw_opacities[:n]),
            means=_host(splats.means[:n]),
        )

    def log_scene(self, dataset) -> None:
        """One-time scene snapshot: camera poses + init point cloud
        (visualize_tools.rs scene/cameras logging)."""
        cams = [dict(position=[float(x) for x in v.camera.position],
                     rotation=[float(x) for x in v.camera.rotation],
                     fov_x=float(v.camera.fov_x),
                     fov_y=float(v.camera.fov_y),
                     image=v.image_path)
                for v in dataset.train.views]
        (self.dir / "scene.json").write_text(json.dumps(
            dict(n_train=len(dataset.train.views),
                 n_eval=0 if dataset.eval is None else len(dataset.eval.views),
                 cameras=cams)))
        if dataset.init_points is not None and len(dataset.init_points):
            np.savez(self.dir / "init_points.npz",
                     points=np.asarray(dataset.init_points),
                     colors=(np.asarray(dataset.init_colors)
                             if dataset.init_colors is not None else
                             np.zeros((0, 3))))

    def log_memory(self, step: int) -> None:
        """Card memory snapshot (the reference logs GPU memory usage to
        rerun on a coarse cadence, train_stream.rs:434-441): each card's
        `utils.tracing.memory_stats()` as mem<i>_<key>. Nothing on the
        CPU."""
        from brush_tpu_torch.utils.tracing import memory_stats
        flat = {}
        for i, (_, s) in enumerate(sorted(memory_stats().items())):
            for k, v in s.items():
                flat[f"mem{i}_{k}"] = v
        if flat:
            self.log_scalars(step, **flat)

    def close(self):
        self._f.close()
