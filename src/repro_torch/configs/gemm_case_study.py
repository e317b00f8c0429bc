"""The paper\'s own case study: distributed GEMM tile-layout configurations
(PolyBench GEMM datasets, paper Fig. 3)."""

DATASETS = {
    # PolyBench/C 4.2.1 GEMM sizes (ni, nj, nk)
    "MINI": (64, 64, 64),  # paper: all dims 64
    "SMALL": (128, 128, 128),
    "MEDIUM": (256, 256, 256),
    "LARGE": (1024, 1024, 1024),
    "EXTRALARGE": (2048, 2560, 1408),  # paper: ni=2048 nj=2560 nk=1408
}

# C/A/B major-dim configurations from Fig. 3 (I/J for C; I/K for A; K/J for B)
LAYOUT_CONFIGS = [
    "I/I/K", "I/I/J", "I/K/K", "I/K/J",
    "J/I/K", "J/I/J", "J/K/K", "J/K/J",
]
