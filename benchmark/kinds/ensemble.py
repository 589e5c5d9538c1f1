"""The "ensemble" kind: an uncertainty engine's predict over `frames`
synthetic height x width frames, one image at a time, in a loop, at native
resolution (the engines' resize -1) with no member saved; each image's mean
and std are read back to the host, as the CLIs do.

Traffic keys: `engine` "mc" (MCDropBlockEngine.predict: `members`, `chunk`,
`drop_prob`) or "rot" (RotationalEngine.predict: `members`, `chunk`,
`warp`); `frames`, `height`, `width`, `vessel_share`; `check_images`, the
window's images that the check recomputes with the reference (drawn from
the seed), `reference_rows` members a reference forward; `limits`.

The window ends at the first image that completes at or after its seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import cells
from benchmark.reference import tasks


class Cell(cells.Cell):
    unit = "image"

    def inputs(self) -> None:
        """The weights and frames, on the device from the seed."""
        self.weights = cells.make_weights(self.cfg, self.seed, self.device)
        self.images, self.targets, self.masks = cells.make_frames(self.traffic, self.seed,
                                                                  self.device)
        self.answers = []  # (frame, image index, mean, std) of the window's images, on the host

    def setup(self) -> None:
        t = self.traffic
        self.inputs()
        self.phase("inputs")
        self.model = cells.port_model(self.cfg, self.weights, self.device)
        self.model.eval()
        common = dict(num_iterations=t["members"], return_num=0, resize=-1, chunk=t["chunk"],
                      device=self.device)
        if t["engine"] == "mc":
            from unet_research_tpu_torch.uncertainty import MCDropBlockEngine

            self.engine = MCDropBlockEngine(self.model, **common)
        else:
            from unet_research_tpu_torch.uncertainty import RotationalEngine

            self.engine = RotationalEngine(self.model, warp=t["warp"], **common)
        self.phase("model and engine")
        self.predict(-1)  # the warm-up image: every chunk shape runs and the body is captured
        self.phase("warm-up image")

    def key_seed(self, i: int) -> int:
        return cells.derive(self.seed, "image", i)

    def predict(self, i: int):
        """Image i of the loop (frame i mod frames): the engine's predict and
        the host's read of its statistics."""
        f = i % self.traffic["frames"]
        sl = slice(f, f + 1)
        args = (self.images[sl], self.targets[sl], self.masks[sl])
        if self.traffic["engine"] == "mc":
            gen = torch.Generator().manual_seed(self.key_seed(i))
            out = self.engine.predict(*args, self.traffic["drop_prob"], generator=gen)
        else:
            out = self.engine.predict(*args)
        return f, out[0][0].cpu(), out[1][0].cpu()

    def window(self, seconds: float) -> cells.Window:
        win = cells.Window(self.unit)
        t0 = time.perf_counter()
        i = 0
        while True:
            s = time.perf_counter()
            f, mean, std = self.predict(i)
            now = time.perf_counter()
            win.seconds.append(now - s)
            ok = bool(torch.isfinite(mean).all() and torch.isfinite(std).all()
                      and mean.min() >= 0 and mean.max() <= 1 and std.min() >= 0)
            win.failed += 0 if ok else 1
            self.answers.append((f, i, mean, std))
            i += 1
            if now - t0 >= seconds:
                break
        win.wall_s = now - t0
        win.attempted = i
        win.work = i * self.traffic["members"]
        return win

    def profile_work(self) -> tuple:
        """(run, work) of one more image of the loop."""
        t = self.traffic
        i = len(self.answers) + 10**6

        def run():
            self.predict(i)

        work = {"forwards": tasks.chunk_sizes(t["members"], t["chunk"]), "h": t["height"],
                "w": t["width"], "dropblock": t["engine"] == "mc"}
        return run, work

    def release(self) -> None:
        """Drop the program's state (the engine, its captured graph, the
        model) before the reference runs."""
        self.engine = self.model = None
        cells.free_device()

    def check(self) -> dict:
        """{number: value}: the worst relative L2 gap of the mean and of the
        std of the sampled images (drawn from the seed among the window's)
        from the reference's."""
        rng = np.random.default_rng(cells.derive(self.seed, "sample"))
        n = min(self.traffic["check_images"], len(self.answers))
        gaps = {"mean_gap": 0.0, "std_gap": 0.0}
        for k in sorted(int(p) for p in rng.choice(len(self.answers), size=n, replace=False)):
            f, i, mean, std = self.answers[k]
            ref_mean, ref_std = self.reference(f, i, quant=False)
            gaps["mean_gap"] = max(gaps["mean_gap"], cells.rel_l2(mean, ref_mean))
            gaps["std_gap"] = max(gaps["std_gap"], cells.rel_l2(std, ref_std))
        return gaps

    def control(self, i: int = 0) -> dict:
        """check()'s numbers of the float8 reference in the program's place,
        on image i of the loop (inputs() is all the set-up it needs)."""
        f = i % self.traffic["frames"]
        q_mean, q_std = self.reference(f, i, quant=True)
        ref_mean, ref_std = self.reference(f, i, quant=False)
        return {"mean_gap": cells.rel_l2(q_mean, ref_mean),
                "std_gap": cells.rel_l2(q_std, ref_std)}

    def reference(self, f: int, i: int, quant: bool) -> tuple:
        t = self.traffic
        sl = slice(f, f + 1)
        image, mask = self.images[sl], self.masks[sl][0]
        if t["engine"] == "mc":
            return tasks.mc_ensemble(self.weights, self.cfg, image, mask, self.key_seed(i),
                                     t["members"], t["chunk"], t["drop_prob"],
                                     self.cfg["dropblock"]["block_size"], t["reference_rows"],
                                     quant)
        return tasks.rot_ensemble(self.weights, self.cfg, image, mask, t["members"],
                                  t["reference_rows"], quant)
