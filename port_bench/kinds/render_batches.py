"""Traffic kind ``render_batches``: a closed loop of one client. Each request
is a batch of frames of a camera panning in yaw from one of a fixed set of
starts, every start once in each cycle, in an order drawn from the seed for
each cycle, so every seed gets the same work in another order. The port
renders the batch (``animation.render_frames``), quantises it on the card
(``ops.render.to_framebuffer``) and the client copies it to the host; the next
batch is submitted when the last has arrived. A frame's latency is its
batch's, from submission to arrival.

The check: pixels of every delivered frame, drawn from the seed, rendered
again by the plain reference with the frame's camera."""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from port_bench import bounds, core, drive, scenes
from port_bench.frozen import work
from port_bench.reference import camera as ref_camera
from port_bench.reference import render as ref_render
from python_ray_tracer_tpu_torch import animation
from python_ray_tracer_tpu_torch.ops.render import to_framebuffer


class Traffic(drive.Kind):
    KEYS = frozenset({"width", "height", "depth", "aliasing", "compat", "batch", "pitch_deg",
                      "fov_deg", "yaw_start_deg", "yaw_starts", "yaw_step_deg",
                      "warmup_batches", "traced_batches"})
    UNIT = "frame"

    def __init__(self, *a):
        super().__init__(*a)
        t = self.traffic
        self.W, self.H, self.n = int(t["width"]), int(t["height"]), int(t["batch"])
        self.kw = dict(depth=int(t["depth"]), aliasing=bool(t["aliasing"]),
                       compat=bool(t["compat"]))
        self.position = np.asarray(self.config["camera"]["position"], np.float32)
        self.fov = float(t["fov_deg"])
        self.P = int(self.params["check_pixels_per_frame"])
        lo, hi = t["yaw_start_deg"]
        k = int(t["yaw_starts"])
        starts = lo + (hi - lo) * (np.arange(k) + 0.5) / k
        # (starts, frames): every batch's yaws, a start's batch stepping from it
        self.yaws = (starts[:, None] + float(t["yaw_step_deg"]) * np.arange(self.n)
                     ).astype(np.float32)
        self.samples: list = []          # (yaws (n,), pixels (n, P, 2), values (n, P, 3))

    def _order(self, stream: int, cycle: int) -> np.ndarray:
        """The starts' order in ``cycle`` of ``stream``, drawn from the seed."""
        return scenes.rng(self.seed, stream, cycle).permutation(self.yaws.shape[0])

    def _start(self, b: int) -> int:
        """The start of the window's stream's batch ``b``."""
        k = self.yaws.shape[0]
        if b // k != self.cycle:
            self.cycle, self.order = b // k, self._order(1, b // k)
        return int(self.order[b % k])

    def setup(self, seconds: float) -> None:
        dev = self.port.device
        self.scene = self.port.scene(self.arrays)
        rot = torch.from_numpy(scenes.euler_rotation(0.0, self.traffic["pitch_deg"],
                                                     self.yaws)).to(dev)
        pos = torch.from_numpy(np.broadcast_to(self.position, self.yaws.shape + (3,)).copy())
        fov = torch.full(self.yaws.shape, self.fov, dtype=torch.float32, device=dev)
        self.cams = (pos.to(dev), rot, fov)        # every start's batch of cameras, once
        fb_shape = (3, self.n, self.W, self.H)
        self.host = (torch.empty(fb_shape, dtype=torch.uint8, pin_memory=True)
                     if self.cuda else None)
        self.next, self.cycle, self.order = 0, -1, None
        self.px_rng = scenes.rng(self.seed, 2)
        self.mark("inputs")
        warm = self._order(0, 0)[:int(self.traffic["warmup_batches"])]
        for i, s in enumerate(warm):
            self._deliver(int(s))
            self.mark(f"warm-up batch {i}")

    def _deliver(self, s: int) -> np.ndarray:
        """Start ``s``'s batch rendered and on the host: uint8 ``(3, n, W, H)``."""
        cams = self.port.cameras(*(t[s] for t in self.cams), (self.W, self.H))
        t0 = drive.now()
        frames = animation.render_frames(cams, self.scene, backend=self.port.backend,
                                         **self.kw)
        self.spans.append(drive.now() - t0)
        fb = to_framebuffer(frames)
        if self.host is None:
            return fb.numpy()
        self.host.copy_(fb, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return self.host.numpy()

    def _request(self) -> tuple:
        """The window stream's next batch, delivered: its start and the host's
        framebuffers."""
        s = self._start(self.next)
        self.next += 1
        return s, self._deliver(s)

    def window(self, seconds: float) -> core.Window:
        lat: List[float] = []
        self.spans = []
        t0 = t = drive.now()
        while t - t0 < seconds:
            ts = drive.now()
            s, fb = self._request()
            t = drive.now()
            lat += [t - ts] * self.n
            self._keep(s, fb)
        return core.Window(t0, t, lat)

    def _keep(self, s: int, fb: np.ndarray) -> None:
        xs = self.px_rng.integers(0, self.W, size=(self.n, self.P))
        ys = self.px_rng.integers(0, self.H, size=(self.n, self.P))
        vals = fb[:, np.arange(self.n)[:, None], xs, ys]             # (3, n, P)
        self.samples.append((self.yaws[s], np.stack([xs, ys], -1).astype(np.int32),
                             np.moveaxis(vals, 0, -1).copy()))

    def stretch(self) -> list:
        """The traced stretch: ``traced_batches`` more requests; returns their
        frames' yaws."""
        out = []
        for _ in range(int(self.traffic["traced_batches"])):
            with torch.profiler.record_function("port_bench.request"):
                s, _ = self._request()
            out.append(self.yaws[s])
        return out

    def release(self) -> None:
        del self.scene, self.cams, self.host

    # the reference -------------------------------------------------------------
    def _ref_cameras(self, yaws: np.ndarray, dtype) -> ref_camera.Camera:
        pos, rot, fov = (torch.as_tensor(np.asarray(x)) for x in (
            np.broadcast_to(self.position, yaws.shape + (3,)).copy(),
            scenes.euler_rotation(0.0, self.traffic["pitch_deg"], yaws),
            np.full(yaws.shape, self.fov, np.float32)))
        return ref_camera.Camera(pos, rot, fov, (self.W, self.H)).to(self.ref_device(), dtype)

    def reference_values(self, dtype=torch.float32, frames: int = 256) -> np.ndarray:
        """uint8 ``(F, P, 3)``: the reference's values of every kept pixel."""
        yaws = np.concatenate([s[0] for s in self.samples])
        pix = np.concatenate([s[1] for s in self.samples])
        scene = self.ref_scene(dtype)
        out = []
        for i in range(0, yaws.shape[0], frames):
            cam = self._ref_cameras(yaws[i:i + frames], dtype)
            px = torch.as_tensor(pix[i:i + frames], device=self.ref_device())
            out.append(ref_render.render_pixels(cam, scene, px, **self.kw).cpu().numpy())
        return np.concatenate(out)

    @staticmethod
    def compare(values: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
        """``px_off_share``: percent of the kept pixels with a channel more
        than one level off the reference; ``worst_frame_off_share``: the
        same percent in the frame that has most."""
        off = (np.abs(values.astype(np.int16) - ref.astype(np.int16)) > 1).any(axis=-1)
        return {"px_off_share": 100.0 * float(off.mean()),
                "worst_frame_off_share": 100.0 * float(off.mean(axis=1).max())}

    def readings(self) -> Dict[str, float]:
        values = np.concatenate([s[2] for s in self.samples])
        return self.compare(values, self.reference_values())

    def control_readings(self, dtype) -> Dict[str, Dict[str, float]]:
        ref = self.reference_values()
        return {f"control_{str(dtype).split('.')[-1]}":
                self.compare(self.reference_values(dtype), ref)}

    def bound_seconds(self, kernel: str, traced: list):
        """For ``render_fwd``: seconds an H100 needs at least for the traced
        frames' renders (:func:`bounds.render_bound_s`), their hits counted by
        the reference's trace of ``bound_positions_per_frame`` distinct sample
        positions of each frame, drawn from the seed and scaled to all of
        them."""
        if kernel != "render_fwd":
            return None
        pos = work.bwd_positions(self.W, self.H, self.kw["aliasing"])
        q = min(int(self.params["bound_positions_per_frame"]), pos.shape[0])
        rng = scenes.rng(self.seed, 4)
        scene = self.ref_scene()
        ns, npl, nl = (scene.spheres.count, scene.planes.count, scene.lights.count)
        total = 0.0
        for yaws in traced:
            for yaw in yaws:
                cam = self._ref_cameras(np.asarray([yaw], np.float32), torch.float32)
                one = ref_camera.Camera(cam.position[0], cam.rotation[0], cam.fov[0],
                                        cam.resolution)
                pick = torch.as_tensor(rng.choice(pos.shape[0], size=q, replace=False))
                counts = work.hard_chain_counts(one, scene, pos[pick], depth=self.kw["depth"],
                                                compat=self.kw["compat"], block=1 << 14)
                scaled = counts * (pos.shape[0] / q)
                total += bounds.render_bound_s(self.W, self.H, pos.shape[0], scaled,
                                               ns, npl, nl)
        return total
