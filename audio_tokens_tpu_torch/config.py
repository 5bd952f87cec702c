"""Single configuration object for every pipeline stage.

A copy of ``audio_tokens_tpu/config.py``: the same fields, defaults,
``from_args`` and ``parse_overrides``, so one config drives both packages.
It is copied rather than imported because importing ``audio_tokens_tpu``
imports jax (its ``__init__`` sets up the XLA compile cache), and this
package never does.  ``tests/test_torch_port.py`` holds the copy equal to
the original field by field.

Fields that only the JAX package reads (mesh shape, compile cache, TPU
tiers) are kept so that a config file or command line means the same thing
to both packages; the port refuses the options it has not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, List, Optional, Sequence

# Root for all artifacts (spectrograms/, tokenized_audio/, output/).  The
# reference anchored these to its repo dir; we anchor to $AUDIO_TOKENS_HOME or
# the current working directory so the package is location-independent.
def _base_dir() -> str:
    return os.environ.get("AUDIO_TOKENS_HOME", os.getcwd())


@dataclass
class AudioTokensConfig:
    random_seed: int = 4242

    # ------------------------------------------------------------------
    # Artifact root (new): all relative default paths resolve under this.
    # ------------------------------------------------------------------
    base_dir: str = field(default_factory=_base_dir)

    # ------------------------------------------------------------------
    # AudiosetMetadataProcessor (reference: audio_tokens_config.py:18-27)
    # ------------------------------------------------------------------
    csv_index_files: List[str] = field(default_factory=list)  # resolved in __post_init__
    ontology_json_file: str = ""  # resolved in __post_init__
    dataset_ratio: float = 0.1  # portion of all ytids to use
    validation_ratio: float = 0.1  # portion of dataset used as validation set

    # Split file shared by splitter + spectrogram stage (reference :30)
    split_file: str = ""

    # ------------------------------------------------------------------
    # SpectrogramGenerator (reference: audio_tokens_config.py:32-41)
    # ------------------------------------------------------------------
    audio_source_path: str = ""
    audio_source_sets: List[str] = field(default_factory=lambda: ["bal_train"])
    dest_spec_path: Path = None  # type: ignore[assignment]
    common_sr: int = 22050
    normalize: bool = False
    n_mels: int = 64
    n_fft: int = 512
    hop_length: int = 128
    # Reference field kept for config parity: there it only chunked the ytid
    # list for tqdm granularity (spectrogram_generator.py:47-52); here decode
    # threading + device_batch_size batching subsume it with no behavioral
    # counterpart.
    spectrogram_batch_size: int = 5000

    # ------------------------------------------------------------------
    # ClusterCreator and ModelTrainer (reference :43-51)
    # ------------------------------------------------------------------
    vocab_size: int = 500
    niter: int = 20
    use_convolution: bool = False
    num_kernels: int = 10
    kernel_size: int = 3
    clustering_batch_size: int = 10000

    # ClusterCreator and SpecTokenizer (reference :53-55)
    centroids_path: Path = None  # type: ignore[assignment]
    source_spec_path: Path = None  # type: ignore[assignment]

    # SpecTokenizer (reference :57-59)
    dest_tokenized_path: str = ""
    tokenizer_batch_size: int = 10000

    # ------------------------------------------------------------------
    # ModelTrainer (reference :61-78)
    # ------------------------------------------------------------------
    use_wandb: bool = False
    wandb_project: str = "audio-tokens"
    tokenized_train_dir: str = ""
    tokenized_val_dir: str = ""
    model_type: str = "lstm"
    num_layers: int = 1
    epochs: int = 100
    hidden_size: int = 768
    num_workers: int = 8
    training_batch_size: int = 8
    learning_rate: float = 1e-4
    num_classes: int = 543
    # Dead in the reference too (only cited by commented-out binary-metric
    # code, utils/metrics_calculator.py:13-21); kept for field parity.
    prediction_threshold: float = 0.2
    lstm_embed_dim: int = 256
    lstm_hidden_dim: int = 512
    dropout: float = 0.0
    use_precomputed_embeddings: bool = False  # True for RawSTFTDataset

    # DataLoaderCreator (reference :80-81)
    dataset_type: str = "TokenizedSpecDataset"

    # ==================================================================
    # TPU-native extensions (no reference counterpart)
    # ==================================================================
    # Fixed device shapes: clips are padded/truncated to this many seconds on
    # device (XLA wants static shapes); true lengths are carried alongside.
    clip_seconds: float = 10.0
    # Number of clips processed per device program in the spectrogram /
    # tokenizer stages (the reference loops clip-at-a-time on the host).
    device_batch_size: int = 64

    # Mesh: axis names and sizes.  data_parallel <= available devices; -1
    # means "all devices".  model_parallel > 1 enables TP sharding on the
    # transformer classifier.  sequence_parallel > 1 shards transformer
    # activations along the frame axis over a 'sequence' mesh axis (full-clip
    # attention at long max_position; bert only — the reference's strategy
    # was truncation, custom_bert_classifier.py:21-22).
    data_parallel: int = -1
    model_parallel: int = 1
    sequence_parallel: int = 1

    # Multi-host (pod-slice) execution: distributed=True calls
    # jax.distributed.initialize() at stage start (autodetected topology on
    # Cloud TPU).  Off-TPU or for explicit topologies set the coordinator
    # and process fields (or the AUDIO_TOKENS_COORDINATOR /
    # AUDIO_TOKENS_NUM_PROCESSES / AUDIO_TOKENS_PROCESS_ID env vars).
    # Meshes then span all processes with 'data' as the DCN-outer axis;
    # stages shard ytids per process; checkpoints/metrics/plots are written
    # by process 0 only.  See parallel/distributed.py.
    distributed: bool = False
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1

    # Numerics. matmul inputs are cast to compute_dtype (bf16 feeds the MXU at
    # full rate); accumulation and params stay float32.
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"

    # Reference-compat switches (SURVEY.md §2.7 quirks, resolved knowingly):
    #   True  -> reproduce reference behavior (all-ones attention masks,
    #            pad-token 0 collision, warm-start batched k-means)
    #   False -> fixed behavior (true lengths, dedicated pad handling,
    #            full-corpus k-means)
    reference_compat: bool = True

    # K-means extensions: cap on points per centroid per train call
    # (FAISS subsamples to 256*k by default; None = use every frame).
    max_points_per_centroid: Optional[int] = None
    # 'batch_warm_start' reproduces the reference's sequential-batch
    # refinement (reference: processors/cluster_creator.py:49-56);
    # 'full' runs Lloyd once over the whole corpus (sharded).
    kmeans_mode: str = "batch_warm_start"
    # 'random' (FAISS-style sample of k points) or 'kmeans++'
    kmeans_init: str = "random"
    # Matmul precision of the Lloyd loop: 'highest' (f32, reproducibility
    # default), 'high' (bf16x3), 'default' (bf16, the fastest; the
    # objective drifts slightly, boundary points change cluster).  The
    # card's times a tier are in PERF.md.  Tokenization has its own tier:
    # tokenizer_precision.
    kmeans_precision: str = "highest"
    # Empty-cluster handling per Lloyd iteration: 'keep' retains the previous
    # centroid (round-1 default); 'split_largest' is a deterministic variant
    # of FAISS's repair (copy the largest cluster's centroid with a symmetric
    # +-1/1024 perturbation) — matters for large vocabularies on narrow data.
    kmeans_empty_policy: str = "keep"
    # kmeans_mode='full' at corpus scale: 'auto' streams super-batches when
    # the estimated frame matrix exceeds kmeans_inmemory_budget_mb (host
    # memory stays bounded by one super-batch); 'always'/'never' force it.
    kmeans_streaming: str = "auto"
    kmeans_inmemory_budget_mb: int = 4096
    kmeans_superbatch_rows: int = 1 << 20
    # Streaming K-means host-RAM cache: >0 caches packed super-batches (up to
    # this many MB) during the first Lloyd iteration and replays them for the
    # rest, so the stream (decode+mel in the fused pipeline) is produced once
    # instead of niter times.  0 disables (memory stays bounded by the
    # transfer pipeline depth); oversized corpora drop the cache and log the
    # per-iteration stream cost.
    kmeans_stream_cache_mb: int = 0
    # Disk-spill tier of that cache: when the packed stream outgrows the
    # host-RAM budget above, entries spill to one sequential file under
    # {base_dir}/output/ (up to this many MB) and later iterations replay
    # memmap views off NVMe instead of re-decoding the corpus — the
    # 'staged' leg of the 2M-clip plan, whose ~880 GB of frames (f32; half
    # with kmeans_wire='bf16') fit neither RAM nor HBM but read back
    # sequentially at GB/s.  The file is per-fit scratch, deleted on
    # completion.  0 disables (oversized corpora then re-stream).
    kmeans_stream_spill_mb: int = 0
    # Streaming K-means DEVICE-resident corpus: >0 retains iteration 0's
    # transferred super-batches in HBM (up to this many MB per process) and
    # runs the remaining niter-1 iterations entirely on device — no decode,
    # no packing, no host link at all after the first pass.  Replay is
    # bit-identical to re-streaming (tested).  The balanced-AudioSet frame
    # corpus is ~8.7 GB f32 (~4.4 bf16 with kmeans_wire='bf16'), so the
    # default holds it on the card beside the Lloyd working set; oversized
    # corpora drop the resident set and fall back to the host cache /
    # re-stream path.  0 disables.
    kmeans_hbm_cache_mb: int = 10240
    # Streaming K-means host->device wire format: 'f32', or 'bf16' (frames
    # rounded once on the host, cast back to f32 on device — half the stream
    # bytes AND half the stream-cache RAM; the 10k-clip rehearsal showed the
    # clustering stage is pure wire on link-bound hosts).  Accumulation
    # precision is unchanged; assignment churn is the bf16-rounding class
    # already measured for kmeans_precision=default.
    kmeans_wire: str = "f32"

    # Trainer extensions.
    resume_from: str = ""  # checkpoint name under checkpoint_dir to resume from
    eval_batch_size: int = 0  # 0 -> same as training_batch_size
    checkpoint_dir: str = ""  # resolved under base_dir/output
    save_best_checkpoint: bool = True
    # Streaming-path progress log cadence (0 disables).  The device-resident
    # epoch path compiles whole epochs into single programs, so it logs per
    # epoch, not per step.
    log_every_steps: int = 50
    early_stopping_patience: int = 0  # 0 disables (reference stub never fired)
    max_train_steps: int = 0  # 0 = no cap (useful for smoke tests)
    # Run gradient-flow diagnostics every N epochs (0 disables — the
    # reference's hook existed but was disabled; see utils/diagnostics.py).
    diagnostics_every: int = 0
    # LSTM recurrence backend of the JAX package: 'auto', 'xla' or
    # 'pallas'.  The port accepts it and routes by device instead: CUDA
    # tensors run kernels B3/B4 (ensembles too, through their member-axis
    # rules), CPU tensors the plain recurrence.
    lstm_backend: str = "auto"
    # Rematerialize the LSTM recurrence in time chunks of this many steps
    # (0 = off).  The backward pass then stores only chunk-boundary (h, c)
    # carries instead of every step's gate activations and recomputes each
    # chunk's forward during backprop (B3 from the chunk's carries, then
    # B4): one chunk's residuals at a time for ~one extra forward of
    # compute, numerics unchanged up to summation order.  It runs inside
    # ensembles (train/ensemble.py) too, where it lets more members share
    # the card; PERF.md gives its memory and time on the H100.
    lstm_remat_chunk: int = 0
    # Transformer attention window (model_type='bert').  512 reproduces the
    # reference, which slices every clip to its first 512 tokens — ~3 s of a
    # 10 s clip (reference: models/custom_bert_classifier.py:21-22).  With
    # flash attention the whole clip is affordable (SURVEY.md §5): set this to
    # max_seq_len (1728) to attend over the whole clip; position embeddings
    # size to this value.  Checkpoints are tied to the setting.
    transformer_max_position: int = 512
    # Transformer attention implementation.  'auto' = the plain (XLA in the
    # JAX package) attention; 'flash' runs the flash kernel (B5 in the port)
    # in deterministic passes, which never materializes the (B, h, T, T)
    # scores.  Which route 'auto' should take on the card is an open
    # question (ROADMAP).
    transformer_attention: str = "auto"
    # Rematerialize each transformer encoder block (jax.checkpoint): the
    # backward keeps only (B, T, H) block boundaries and recomputes the
    # O(T^2) attention scores during backprop — numerics unchanged, ~one
    # extra forward of compute.  The memory lever for big-batch training
    # at full-clip attention (transformer_max_position = max_seq_len),
    # where the (B, heads, T, T) score residuals otherwise bound batch
    # size.
    transformer_remat: bool = False
    # Megakernel DFT/mel GEMM tier: 'highest' (f32, bit-exact tokens),
    # 'bf16x3' (bf16 products, three a product; near-ties apart), 'default'
    # (bf16, faster again, ~1% of tokens apart).  The card's times and
    # agreement a tier are in PERF.md.
    tokenizer_precision: str = "highest"
    # VQ distance GEMM tier (the argmin decision point), separately: at the
    # default 500-centroid vocabulary it is a small FLOP fraction and
    # 'highest' costs nothing, but at the 16k north-star vocabulary it is
    # ~97% of the kernel FLOPs, where the bf16 tiers pay most (PERF.md
    # gives B1 a tier at 16,384 centroids on the H100).
    tokenizer_vq_precision: str = "highest"
    # Consolidated memory-mapped training-input cache: token sequences are
    # packed once into {split}.tokcache.bin (uint16) + offsets, so per-clip
    # loads become zero-copy slices instead of np.load file opens (built
    # lazily, staleness-checked against per-clip artifact mtimes, process-0
    # built under multi-host).  Off: read per-ytid .npy like the reference.
    token_cache: bool = True
    # Byte budget for building that cache (MB): construction is skipped when
    # the encoded corpus would exceed it (the float32 spectrogram cache of a
    # 2M-clip corpus is ~880 GB — per-file loads remain correct).  The
    # 2M-clip uint16 TOKEN corpus is ~6.6 GB and fits the default.  0 = no
    # budget.  The build streams clip-at-a-time to disk either way (host RAM
    # stays one clip deep).
    input_cache_budget_mb: int = 8192
    # Host->device waveform wire format for EVERY native-decode device
    # path (staged spectrograms, fused tokenizer, all-device cluster feed,
    # serving): 'f32', or 'i16' PCM (half the transfer bytes; bit-exact for
    # mono 16-bit sources at common_sr, <=-96 dB quantization noise for
    # resampled/downmixed clips).  One decode rule
    # (ops/mel.decode_wire, applied inside the frontend) covers all paths,
    # so pipeline routing decisions never change numerics.
    pcm_wire: str = "f32"
    # Device-resident training corpus (train/device_epoch.py): ship each
    # split's inputs/labels to HBM once and compile whole epochs into single
    # XLA programs (on-device batch gathers + exact on-device mAP; an epoch
    # fetches two scalars).  'auto' engages when the corpora fit the budget
    # below and the mesh is DP-only; 'on' forces (errors under TP); 'off'
    # always streams per-step batches (required at spec-corpus scale).
    device_corpus: str = "auto"
    device_corpus_budget_mb: int = 4096
    # HBM storage dtype for resident spec/flat corpora: 'float32' (exact) or
    # 'bfloat16' (half the residency — a 22k-clip spec corpus drops 9.8 ->
    # 4.9 GB, doubling what fits the budget; one round-to-nearest of the
    # dB spectrogram inputs, ~3 decimal digits preserved).  Token corpora always pack uint16 and
    # ignore this.
    device_corpus_dtype: str = "float32"
    # How the device-resident epoch composes shuffled batches:
    # 'step' gathers batch_size permuted rows inside every scan step;
    # 'epoch' gathers the whole permuted corpus ONCE per epoch and steps
    # through contiguous slices (same bytes, but the bulk gather runs at HBM
    # rate instead of serializing with each model step — measured 2x the
    # whole step for wide-row families); costs one transient corpus-sized
    # copy of the inputs.  'auto' picks 'epoch' for spec/flat corpora when
    # the copy fits device_corpus_budget_mb, 'step' for token corpora
    # (their rows are KBs; the gather is already negligible).
    device_epoch_gather: str = "auto"
    # Device-epoch mAP accumulation: 0 = exact on-device metric (stores the
    # epoch's (n_pad, C) sigmoids in HBM — ~70 GB at 2M clips x 543 classes,
    # 10x the token corpus itself); >0 = constant-memory histogram metric
    # with this many score buckets carried through the epoch scan
    # (2 x C x bins int32, ~36 MB at 543 x 8192; error ~1/bins — the device
    # twin of streaming_map_bins).  The lever that keeps corpus-scale token
    # epochs device-resident.
    device_map_bins: int = 0
    # Epoch-mAP accumulation: 0 keeps every sigmoid in host RAM (exact,
    # reference semantics; ~4.3 GB/epoch at 2M clips); >0 switches to the
    # constant-memory histogram estimator with this many score buckets
    # (error ~1/bins; see utils/metrics.StreamingMAP).
    streaming_map_bins: int = 0
    # Sequence capacity for token models (frames for 10 s @ hop 128 = 1723,
    # padded up to a lane-friendly multiple).
    max_seq_len: int = 1728

    # Audio decode backend: 'auto' prefers the native C++ decoder when built,
    # falling back to the pure-python reader.
    audio_backend: str = "auto"

    # Observability: when set, stages run under torch.profiler
    # (utils/profiling.maybe_trace), one Chrome/Perfetto trace a call in this
    # directory, carrying the layers' atk/ spans.
    profile_dir: str = ""

    # Stage resumability: the reference wipes stage output dirs on every run
    # (SURVEY.md §2.7.8). incremental=True keeps existing artifacts and only
    # processes missing ones, so an interrupted spectrogram/tokenize run over
    # the 2M-clip corpus resumes where it stopped.
    incremental: bool = False

    # Fused pipeline: stages read audio directly and compute mel frames on
    # device instead of round-tripping spectrogram ``.npy`` artifacts through
    # disk — clustering streams wav->frames and tokenization runs the fused
    # wav->tokens program (kernel B1 on the card).  Token artifacts
    # are byte-identical to the staged pipeline (tested); the spectrogram
    # stage is skipped entirely by run_pipeline.
    fused_pipeline: bool = False

    def __post_init__(self) -> None:
        base = self.base_dir
        # Metadata assets resolve to {base_dir}/metadata when the user placed
        # them there, falling back to the copies bundled at the repo root
        # (the reference ships the same files in its metadata/ dir).
        bundled = Path(__file__).resolve().parents[1] / "metadata"

        def _meta(name: str) -> str:
            user = Path(base) / "metadata" / name
            return str(user if user.exists() else bundled / name)

        if not self.csv_index_files:
            self.csv_index_files = [_meta("balanced_train_segments.csv")]
        if not self.ontology_json_file:
            self.ontology_json_file = _meta("ontology.json")
        if not self.split_file:
            self.split_file = f"{base}/output/bal_train_data_split.json"
        if not self.audio_source_path:
            self.audio_source_path = f"{base}/audioset"
        if self.dest_spec_path is None:
            self.dest_spec_path = Path(f"{base}/spectrograms")
        if self.centroids_path is None:
            self.centroids_path = Path(f"{base}/output/centroids.npy")
        if self.source_spec_path is None:
            self.source_spec_path = Path(f"{base}/spectrograms")
        if not self.dest_tokenized_path:
            self.dest_tokenized_path = f"{base}/tokenized_audio/"
        # derive the dataset read dirs from the tokenizer WRITE dir so an
        # overridden dest_tokenized_path keeps writer and reader aligned
        # (the reference derived all three from BASE_DIR independently,
        # audio_tokens_config.py:58,64-65)
        dest = self.dest_tokenized_path.rstrip("/")
        if not self.tokenized_train_dir:
            self.tokenized_train_dir = f"{dest}/train/"
        if not self.tokenized_val_dir:
            self.tokenized_val_dir = f"{dest}/validation/"
        if not self.checkpoint_dir:
            self.checkpoint_dir = f"{base}/output/checkpoints"
        if not self.eval_batch_size:
            self.eval_batch_size = self.training_batch_size
        if self.pcm_wire not in ("f32", "i16"):
            raise ValueError(f"pcm_wire must be 'f32' or 'i16', "
                             f"got '{self.pcm_wire}'")
        if self.device_epoch_gather not in ("auto", "step", "epoch"):
            raise ValueError(
                f"device_epoch_gather must be 'auto', 'step' or 'epoch', "
                f"got '{self.device_epoch_gather}'")
        if self.device_map_bins < 0:
            raise ValueError(
                f"device_map_bins must be >= 0, got {self.device_map_bins}")
        self.dest_spec_path = Path(self.dest_spec_path)
        self.centroids_path = Path(self.centroids_path)
        self.source_spec_path = Path(self.source_spec_path)

    # ------------------------------------------------------------------
    # Derived quantities
    # ------------------------------------------------------------------
    @property
    def clip_samples(self) -> int:
        return int(round(self.clip_seconds * self.common_sr))

    @property
    def frames_per_clip(self) -> int:
        """STFT frame count for a full-length clip (center-padded)."""
        return 1 + self.clip_samples // self.hop_length

    @property
    def feature_dim(self) -> int:
        """Dimensionality of one frame vector fed to K-means / VQ."""
        d = self.n_mels
        if self.use_convolution:
            d *= self.num_kernels
        return d

    # ------------------------------------------------------------------
    # CLI / file overlay
    # ------------------------------------------------------------------
    @classmethod
    def from_args(cls, argv: Optional[Sequence[str]] = None) -> "AudioTokensConfig":
        """Build a config from ``--field value`` CLI flags.

        ``--config file.json`` loads a JSON dict first; explicit flags win.
        Field types are inferred from the dataclass annotations.
        """
        import argparse

        parser = argparse.ArgumentParser(description="audio-tokens-tpu config")
        parser.add_argument("--config", type=str, default=None, help="JSON config file")
        fields = {f.name: f for f in dataclasses.fields(cls)}
        for name, f in fields.items():
            parser.add_argument(f"--{name}", type=str, default=None)
        ns, _ = parser.parse_known_args(argv)

        overrides: dict = {}
        if ns.config:
            with open(ns.config) as fh:
                overrides.update(json.load(fh))
        for name in fields:
            raw = getattr(ns, name)
            if raw is not None:
                overrides[name] = _coerce(raw, fields[name])
        return cls(**overrides)

    @classmethod
    def parse_overrides(cls, argv: Sequence[str]) -> dict:
        """Coerce leftover ``--field value`` / ``--field=value`` tokens
        (e.g. ``parse_known_args`` remainders from a tool's own parser)
        into a config-kwargs dict.  Unknown fields and dangling values
        raise — tools share one overlay rule instead of hand-rolling it."""
        fields = {f.name: f for f in dataclasses.fields(cls)}
        flat: list = []
        for tok in argv:
            flat.extend(tok.split("=", 1)
                        if tok.startswith("--") and "=" in tok else [tok])
        if len(flat) % 2:
            raise SystemExit(f"dangling config override: {flat[-1]}")
        out: dict = {}
        for name, val in zip(flat[::2], flat[1::2]):
            name = name.lstrip("-")
            if name not in fields:
                raise SystemExit(f"unknown config field --{name}")
            out[name] = _coerce(val, fields[name])
        return out

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = str(v) if isinstance(v, Path) else v
        return out


def _coerce(raw: str, f: dataclasses.Field) -> Any:
    """Coerce a CLI string to the dataclass field's type."""
    ann = f.type if isinstance(f.type, str) else str(f.type)
    if "bool" in ann:
        return raw.lower() in ("1", "true", "yes", "on")
    if "int" in ann and "Optional" not in ann:
        return int(raw)
    if "Optional[int]" in ann:
        return None if raw.lower() in ("none", "null") else int(raw)
    if "float" in ann:
        return float(raw)
    if "List[str]" in ann:
        return [s for s in raw.split(",") if s]
    if "Path" in ann:
        return Path(raw)
    return raw
