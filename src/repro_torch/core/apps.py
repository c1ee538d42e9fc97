"""AWS digital twin for the paper's three applications (Sec. II-B, IV-C).

We have no AWS/Greengrass/Raspberry-Pi access (the repro hardware gate), so
this module is a *generative stand-in for the measurement environment*: it
produces component-latency samples whose statistics are calibrated to the
paper's published numbers (Table I means; end-to-end magnitudes of Tables
III–V; the CPU∝memory AWS container model saturating at the 1792 MB full-vCPU
point; the lognormal comp-time variance the paper highlights for cloud
pipelines vs. the low-variance edge).

The twin plays two roles, mirroring the paper's methodology exactly:
1. *training data collection* (Sec. IV-C): sampled component measurements used
   to fit the performance models — the models never see the generator's form;
2. *ground truth during simulation* (Sec. VI-A): fresh actual latencies for
   each simulated execution, including actual (stochastic) container
   lifetimes, so warm/cold mispredictions occur naturally.

Applications:
- IR  (image resize, Images-of-Groups-like size distribution, 4 inputs/s)
- FD  (dlib face detection, same inputs, 4 inputs/s)
- STT (pocketsphinx transcription, Tatoeba-like clips, 0.1 inputs/s)
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.workload import PoissonWorkload, TaskInput

# The paper's 19 memory configurations: 640 MB … 2944 MB in 128 MB steps.
MEMORY_CONFIGS_MB: tuple[int, ...] = tuple(range(640, 3008, 128))
assert len(MEMORY_CONFIGS_MB) == 19

# AWS grants CPU proportionally to memory; a full vCPU arrives at 1792 MB.
FULL_VCPU_MB = 1792.0


def cpu_share(memory_mb: float) -> float:
    return min(memory_mb, FULL_VCPU_MB) / FULL_VCPU_MB


@dataclass(frozen=True)
class AppSpec:
    """Ground-truth generative parameters for one application."""

    name: str
    arrival_rate_per_s: float
    # cloud compute: comp = (c0 + c1 * size_scaled) / cpu_share(m) * LN(0, comp_sigma)
    c0_ms: float
    c1_ms: float  # per scaled-size unit (Mpix for IR/FD, ms-audio for STT)
    comp_sigma: float
    # edge compute: comp = (e0 + e1 * size_scaled) * LN(0, edge_sigma)
    e0_ms: float
    e1_ms: float
    edge_sigma: float
    # startup (Table I): warm/cold normal means and stds
    warm_mean: float
    warm_std: float
    cold_mean: float
    cold_std: float
    # storage / iot upload (Table I)
    store_cloud_mean: float
    store_cloud_std: float
    store_edge_mean: float
    store_edge_std: float
    iotup_mean: float  # 0 ⇒ not part of pipeline (IR sends directly to S3)
    iotup_std: float
    # network
    upld_base_ms: float
    upld_ms_per_byte: float
    upld_sigma: float
    size_kind: str = "pixels"  # or "bytes"

    def size_scaled(self, size: float) -> float:
        if self.size_kind == "pixels":
            return size / 1e6  # megapixels
        return size / 32.0 / 1000.0  # bytes -> seconds of 16 kHz 16-bit mono audio


# Calibration notes (see DESIGN.md §2):
#  - warm/cold/store/iotup means match Table I;
#  - FD edge comp ≈ 7.7 s reproduces the paper's edge-only 2404 s queue collapse;
#  - IR edge pipeline ≈ 1.3 s (faster than small-memory cloud, paper Fig. 5a);
#  - STT edge comp ≈ 11 s with 10 s arrivals → edge viable at large δ (Fig. 5c).
IR = AppSpec(
    name="IR", arrival_rate_per_s=4.0,
    c0_ms=24.0, c1_ms=36.0, comp_sigma=0.25,        # high cloud variance (paper Fig. 3)
    e0_ms=180.0, e1_ms=290.0, edge_sigma=0.04,
    warm_mean=162.0, warm_std=25.0, cold_mean=741.0, cold_std=90.0,
    store_cloud_mean=549.0, store_cloud_std=250.0,
    store_edge_mean=579.0, store_edge_std=25.0,
    iotup_mean=0.0, iotup_std=0.0,  # IR sends the thumbnail directly to S3
    upld_base_ms=60.0, upld_ms_per_byte=1.0 / 3125.0, upld_sigma=0.25,
    size_kind="pixels",
)

FD = AppSpec(
    name="FD", arrival_rate_per_s=4.0,
    c0_ms=80.0, c1_ms=280.0, comp_sigma=0.18,
    e0_ms=600.0, e1_ms=3600.0, edge_sigma=0.05,
    warm_mean=163.0, warm_std=25.0, cold_mean=1500.0, cold_std=180.0,
    store_cloud_mean=584.0, store_cloud_std=150.0,
    store_edge_mean=583.0, store_edge_std=25.0,
    iotup_mean=25.0, iotup_std=6.0,
    upld_base_ms=60.0, upld_ms_per_byte=1.0 / 3125.0, upld_sigma=0.15,
    size_kind="pixels",
)

STT = AppSpec(
    name="STT", arrival_rate_per_s=0.1,
    c0_ms=150.0, c1_ms=230.0, comp_sigma=0.20,      # per second of audio
    e0_ms=800.0, e1_ms=2500.0, edge_sigma=0.18,
    warm_mean=145.0, warm_std=25.0, cold_mean=1404.0, cold_std=150.0,
    store_cloud_mean=533.0, store_cloud_std=150.0,
    store_edge_mean=579.0, store_edge_std=25.0,
    iotup_mean=27.0, iotup_std=6.0,
    upld_base_ms=60.0, upld_ms_per_byte=1.0 / 3125.0, upld_sigma=0.15,
    size_kind="bytes",
)

APPS: dict[str, AppSpec] = {"IR": IR, "FD": FD, "STT": STT}

# Actual (stochastic) container lifetime in the provider: N(27 min, 2 min).
T_IDL_ACTUAL_MEAN_MS = 27.0 * 60e3
T_IDL_ACTUAL_STD_MS = 2.0 * 60e3


@dataclass
class AWSTwin:
    """Generative ground truth for one application across all configurations."""

    spec: AppSpec
    seed: int = 0
    rng: np.random.Generator = field(init=False)

    def __post_init__(self):
        self.rng = np.random.default_rng(self.seed)

    # ------------------------------------------------------------- inputs
    def sample_input(self, rng: np.random.Generator) -> tuple[float, float]:
        """Returns (size_feature, payload_bytes)."""
        if self.spec.size_kind == "pixels":
            # Images-of-Groups-like: Flickr photos at standard resolutions
            # (~1.9–2.9 Mpix), JPEG ~0.35 B/px
            pixels = rng.uniform(1.9e6, 2.9e6)
            return float(pixels), float(pixels * 0.35)
        # Tatoeba-like clips: lognormal duration ~3.5 s, 16 kHz 16-bit mono WAV
        dur_s = float(np.clip(rng.lognormal(np.log(3.5), 0.45), 1.0, 12.0))
        nbytes = dur_s * 32_000.0
        return float(nbytes), float(nbytes)

    def sample_input_batch(self, rng: np.random.Generator,
                           n: int) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized ``sample_input``: ``n`` inputs as one block draw.

        Consumes the Generator stream exactly like ``n`` sequential
        ``sample_input`` calls (one uniform / one lognormal per input — numpy
        Generators produce the same values drawn singly or as a block), so
        streaming workload generators built on it are bit-identical to the
        per-task loop. This is what makes 10M-task workloads generable in
        seconds instead of minutes.
        """
        if self.spec.size_kind == "pixels":
            pixels = rng.uniform(1.9e6, 2.9e6, size=n)
            return pixels, pixels * 0.35
        dur_s = np.clip(rng.lognormal(np.log(3.5), 0.45, size=n), 1.0, 12.0)
        nbytes = dur_s * 32_000.0
        return nbytes, nbytes.copy()

    def workload(self, n: int, seed: int = 0) -> list[TaskInput]:
        return self.poisson(seed).generate(n)

    def poisson(self, seed: int = 0) -> PoissonWorkload:
        """The app's Poisson workload source (list via ``generate``, streaming
        ``TaskChunk``s via ``chunks`` — both bit-identical task streams)."""
        return PoissonWorkload(
            rate_per_s=self.spec.arrival_rate_per_s,
            size_sampler=self.sample_input,
            size_sampler_batch=self.sample_input_batch,
            seed=seed,
        )

    # ----------------------------------------------------- actual latencies
    def upld_ms(self, nbytes: float, rng=None) -> float:
        rng = rng or self.rng
        base = self.spec.upld_base_ms + nbytes * self.spec.upld_ms_per_byte
        return float(base * rng.lognormal(0.0, self.spec.upld_sigma))

    def start_ms(self, cold: bool, rng=None) -> float:
        rng = rng or self.rng
        if cold:
            return float(max(rng.normal(self.spec.cold_mean, self.spec.cold_std), 1.0))
        return float(max(rng.normal(self.spec.warm_mean, self.spec.warm_std), 1.0))

    def comp_cloud_ms(self, size: float, memory_mb: float, rng=None) -> float:
        rng = rng or self.rng
        s = self.spec.size_scaled(size)
        base = (self.spec.c0_ms + self.spec.c1_ms * s) / cpu_share(memory_mb)
        return float(base * rng.lognormal(0.0, self.spec.comp_sigma))

    def store_cloud_ms(self, rng=None) -> float:
        rng = rng or self.rng
        return float(max(rng.normal(self.spec.store_cloud_mean, self.spec.store_cloud_std), 1.0))

    def comp_edge_ms(self, size: float, rng=None) -> float:
        rng = rng or self.rng
        s = self.spec.size_scaled(size)
        base = self.spec.e0_ms + self.spec.e1_ms * s
        return float(base * rng.lognormal(0.0, self.spec.edge_sigma))

    def iotup_ms(self, rng=None) -> float:
        if self.spec.iotup_mean <= 0:
            return 0.0
        rng = rng or self.rng
        return float(max(rng.normal(self.spec.iotup_mean, self.spec.iotup_std), 0.0))

    def store_edge_ms(self, rng=None) -> float:
        rng = rng or self.rng
        return float(max(rng.normal(self.spec.store_edge_mean, self.spec.store_edge_std), 1.0))

    def t_idl_ms(self, rng=None) -> float:
        rng = rng or self.rng
        return float(max(rng.normal(T_IDL_ACTUAL_MEAN_MS, T_IDL_ACTUAL_STD_MS), 5 * 60e3))


@dataclass
class Measurements:
    """Training measurements collected by running the pipelines (Sec. IV-C)."""

    # cloud (warm-start collection runs)
    sizes: np.ndarray
    nbytes: np.ndarray
    memory: np.ndarray
    upld: np.ndarray
    comp: np.ndarray
    store: np.ndarray
    start_warm: np.ndarray
    start_cold: np.ndarray
    # edge
    edge_sizes: np.ndarray
    edge_comp: np.ndarray
    iotup: np.ndarray
    edge_store: np.ndarray


def collect_measurements(
    twin: AWSTwin,
    n_inputs: int | None = None,
    configs: tuple[int, ...] = MEMORY_CONFIGS_MB,
    n_cold: int = 100,
    seed: int = 1,
) -> Measurements:
    """Reproduce the paper's data collection (1400 images / 3400 clips; 100 cold
    starts per config; warm-start pipeline runs for every (input, config))."""
    if n_inputs is None:
        n_inputs = 3400 if twin.spec.name == "STT" else 1400
    rng = np.random.default_rng(seed)
    inputs = [twin.sample_input(rng) for _ in range(n_inputs)]

    sizes, nbytes_l, memory, upld, comp, store = [], [], [], [], [], []
    for size, nb in inputs:
        for m in configs:
            sizes.append(size)
            nbytes_l.append(nb)
            memory.append(float(m))
            upld.append(twin.upld_ms(nb, rng))
            comp.append(twin.comp_cloud_ms(size, m, rng))
            store.append(twin.store_cloud_ms(rng))
    start_warm = np.array([twin.start_ms(False, rng) for _ in range(n_inputs)])
    start_cold = np.array([twin.start_ms(True, rng) for _ in range(n_cold * len(configs))])

    edge_sizes = np.array([s for s, _ in inputs])
    edge_comp = np.array([twin.comp_edge_ms(s, rng) for s, _ in inputs])
    iotup = np.array([twin.iotup_ms(rng) for _ in range(n_inputs)])
    edge_store = np.array([twin.store_edge_ms(rng) for _ in range(n_inputs)])

    return Measurements(
        sizes=np.array(sizes), nbytes=np.array(nbytes_l), memory=np.array(memory),
        upld=np.array(upld), comp=np.array(comp), store=np.array(store),
        start_warm=start_warm, start_cold=start_cold,
        edge_sizes=edge_sizes, edge_comp=edge_comp, iotup=iotup, edge_store=edge_store,
    )
