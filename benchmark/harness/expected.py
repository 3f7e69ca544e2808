"""A fixed world's frames with the answers that an independent implementation
gave on them: one file `expected/<name>.npz`, named by the traffic's
`expected` setting.

It holds the inputs that the program and the comparison both read (gray
images, the 2D detector's boxes, camera poses, intrinsics), the expected
answers per frame, and the settings they were made with.  Set-up reads the
frames from it instead of rendering them, so the inputs are the file's bits
on every machine.  `expected/make_expected.py` writes it.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from harness.world import SynthSequence

# the settings that decide the frames or the answers; a run whose settings
# differ from the file's in any of them cannot use it
SETTINGS = ("size", "n_frames", "world_seed", "tilt_deg", "n_objects", "speed", "curve",
            "noise_px", "dropout", "ground_texture", "max_detections", "dtype", "top_k",
            "sample_height", "sample_roll_pitch", "skew")
ANSWERS = ("lines", "lmask", "valid", "pos", "scale", "rotY", "normalized_error")


def file_of(bench_dir: pathlib.Path, name: str) -> pathlib.Path:
    return bench_dir / "expected" / f"{name}.npz"


def save(path: pathlib.Path, world: SynthSequence, answers: list, settings: dict,
         made_by: str) -> None:
    """`answers`: one dict of arrays (the keys of ANSWERS) per frame."""
    n_det = np.array([len(d) for d in world.detections])
    det = np.zeros((len(n_det), max(n_det.max(initial=0), 1), 5))
    for i, d in enumerate(world.detections):
        det[i, :len(d)] = d
    meta = {"settings": {k: settings[k] for k in SETTINGS}, "made_by": made_by}
    np.savez_compressed(
        path, meta=np.array(json.dumps(meta)), K=world.K, T_wc=world.T_wc,
        images=np.stack(world.images), detections=det, n_detections=n_det,
        **{k: np.stack([a[k] for a in answers]) for k in ANSWERS})


def load(path: pathlib.Path, settings: dict) -> tuple:
    """(the world, the answers as a dict of arrays with a leading frame axis,
    the keys of SETTINGS whose values differ from the file's)."""
    with np.load(path) as f:
        meta = json.loads(str(f["meta"]))
        n_det = f["n_detections"]
        world = SynthSequence(K=f["K"], T_wc=f["T_wc"], images=list(f["images"]),
                              detections=[d[:n] for d, n in zip(f["detections"], n_det)],
                              objects=[], timestamps=np.arange(len(n_det), dtype=np.float64))
        answers = {k: f[k] for k in ANSWERS}
    differ = [k for k in SETTINGS if meta["settings"].get(k) != settings.get(k)]
    return world, answers, differ
