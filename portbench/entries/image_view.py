"""Image frames: ``ImageTrainer.render`` of the whole fitted image at the
cell's frame size, one frame a call, returned to the host as numpy.

The trainer is made on the seeded test image (its size sets the grid) with
the benchmark's weights from the seed, untrained: a frame's work does not
depend on the weights. Set-up renders the warm-up frames. After the window
a seeded sample of the window's frames is compared with the plain
reference's frame.
"""
from __future__ import annotations

from portbench.entries.base import Sample, frame_metrics
from portbench.entries.image_train import Entry as ImageTrain
from portbench.lib import compare
from portbench.reference import image as ref


class Entry(ImageTrain):
    unit = "frame"
    passes = 1

    def __init__(self, *a):
        super().__init__(*a)
        self.W, self.H = (int(x) for x in self.traffic["frame"])
        self.kept = Sample(self.seed + 1, int(self.traffic["compare_frames"]),
                           int(self.traffic["compare_among"]))

    def setup(self):
        self.tr = self.make_trainer()
        for _ in range(int(self.traffic["warmup_frames"])):
            self.tr.render(self.W, self.H)

    def call(self) -> int:
        self.kept.offer(self.tr.render(self.W, self.H))
        return 1

    def window_metrics(self, units, window_s, per_call_ms) -> dict:
        return frame_metrics(units, window_s, per_call_ms)

    def after_window(self) -> dict:
        return {}

    def reference(self, prec: str = "f32"):
        res = int(self.data["resolution"])
        return ref.frame(self._weights(), self.config, (res, res), self.W,
                         self.H, prec)

    def check(self) -> list:
        self.ref = self.reference()
        return compare.frames([(got, self.ref) for got in self.kept.kept],
                              self.limits)

    def control(self) -> list:
        return compare.frames([(self.reference("bf16"), self.ref)],
                              self.limits)
