"""The paper's own model zoo (Table 3; ``repro/configs/phub_paper.py``):
CNNs used only by the cost model and the analytic figures (bandwidth lower
bounds, Table 2/5 analogues).  The port trains the assigned transformer
pool instead."""
from dataclasses import dataclass


@dataclass(frozen=True)
class PaperModel:
    name: str
    abbr: str
    model_bytes: int          # model size
    time_per_batch_s: float   # fwd+bwd on a GTX 1080 Ti (paper Table 3)
    batch: int


MB = 1 << 20
PAPER_MODELS = {
    m.abbr: m for m in (
        PaperModel("AlexNet", "AN", 194 * MB, 0.016, 32),
        PaperModel("VGG 11", "V11", 505 * MB, 0.121, 32),
        PaperModel("VGG 19", "V19", 548 * MB, 0.268, 32),
        PaperModel("GoogleNet", "GN", 38 * MB, 0.100, 32),
        PaperModel("Inception V3", "I3", 91 * MB, 0.225, 32),
        PaperModel("ResNet 18", "RN18", 45 * MB, 0.054, 32),
        PaperModel("ResNet 50", "RN50", 97 * MB, 0.161, 32),
        PaperModel("ResNet 269", "RN269", 390 * MB, 0.350, 16),
        PaperModel("ResNext 269", "RX269", 390 * MB, 0.386, 8),
    )
}
