"""KV-cache generation engine: greedy autoregressive serving of the
TransformerLM with a paged KV pool, prefix-cache reuse, chunked prefill,
speculative decoding and token-level continuous batching.

Port of ``kubeflow_tpu/compute/generate.py`` (the engine at :595) on a
float or int8 pool, with QoS admission, preemptible decoding, KV-page
migration between prefill and decode replicas and tensor-sharded
serving over a mesh. Its wire surface (deadlines, drain, ``close``,
the header and done-frame views, the ``serving_generate_*``,
``serving_kv_*`` and ``serving_qos_*`` families) is the JAX engine's:
``compute/serving.py`` streams it over HTTP.

- **Paged KV pool**: one pool of ``num_blocks`` blocks of ``block_size``
  positions per layer, shared by all sequences; a sequence holds a block
  table (logical block → physical block). Blocks are refcounted.
  Admission reserves the worst-case block count, so a running sequence
  never meets an allocation failure.
- **Prefix cache** (``prefix_cache=True``, the default as in JAX): a
  radix trie over FULL prompt blocks maps every seen block-aligned
  prefix to the page holding its K/V. Admission pins the matched pages
  into the new table and prefills only the unshared suffix; eviction
  keeps indexed pages cached at refcount 0, reclaimed LRU leaf-first
  when the pool runs short.
- **int8 KV** (``kv_dtype="int8"``): the pool holds int8 pages plus one
  fp32 scale per (position, head) (``quantize.kv_quantize``), written
  quantized and widened inside the pool reads (K1-i8 and K2-i8 on the
  card), half the page bytes of bf16. The draft's dense cache stays
  float.
- **Prefill**: a cold prompt padded to its ``serving.bucket_for``
  bucket goes through one causal forward (attention on the K3 kernel,
  ``ops/flash_attention.py``); a suffix after a prefix hit, and every
  chunk of a chunked prefill (``prefill_chunk``), reads the cached
  prefix through the K2 kernel (``ops/paged_attention.py``). Each
  writes its K/V into fresh pages; the last real row gives the first
  token. ``stats`` count the calls' work: ``prefill_tokens_total``
  (prompt positions computed) and ``prefill_attn_pairs_total`` (the
  causal query-key pairs they attend, no window), and of the K2 calls
  alone ``prefill_cached_tokens_total``,
  ``prefill_cached_prefix_total`` (the cached positions read) and
  ``prefill_cached_attn_pairs_total``.
- **Decode**: one step advances every decoding slot by one token —
  write the new token's K/V into its page, then read the pool through
  the K1 kernel over ``length + 1`` positions. With a draft model
  (``spec_k > 0``) a round instead lets the draft propose up to
  ``spec_k`` tokens per slot, verifies them all in one target forward
  whose pool read is K2 with per-slot prefix lengths, and emits the
  accepted prefix plus the target's own next token.
- **The plain decode step has one fixed shape**: every one of the
  ``max_slots`` rows writes a K/V row and reads ``(length + 1) ·
  active`` positions; a row that is not decoding (a free slot, a slot
  still prefilling) writes into the pool's *sink block*, one block past
  the ``num_blocks`` the allocator hands out, which no table names. Its
  host input is one packed int32 buffer (``_step_views``), pinned on a
  card and copied over in one transfer. Where every shard sits on one
  CUDA device the step is captured once as a CUDA graph (after one
  eager run on a side stream, into a private memory pool) and every
  later step replays it (``_decode_launch``); the capture is keyed on
  the storage of the weights and the pool, and a reload captures
  again. On the CPU, and across distinct devices, the same step runs
  eagerly.
- **Mixed models** (``transformer.PortConfig``: the AFMoE family, and
  dropless mixtures of experts): on one card, as every one-shard
  engine, the layers run through ``transformer.layer_core``'s
  unsharded form (the family's parts in it), a sliding layer's window
  reaching K3, K2 and K1 (each walk starts at the window), a global
  layer without RoPE where the model says so, and the experts on the
  grouped matmul (K6) inside the decode step's graph. Every layer's
  pages stay in the one shared pool. Each expert call is counted in
  ``stats`` (``moe_calls``, ``moe_assignments_total``,
  ``moe_padded_rows_total``, ``moe_active_experts_total``, and the
  decode step's share of them as ``moe_decode_calls``,
  ``moe_decode_assignments_total``,
  ``moe_decode_active_experts_total``); the active experts are tallied
  on the card and ride the step's token copy (a prefill's, its first
  token's), so no sync is added. Capacity
  dispatch (which drops tokens), a mesh and a draft are refused.
- **Continuous batching**: finished sequences leave mid-batch and
  queued prompts take their slots; one engine-loop iteration is sweep
  the queue (deadlines, cancels) → admit → sweep the slots → advance one
  prefill chunk → one decode (or speculative) step.
  ``admission="drain"`` is the drain-then-refill baseline: admit only
  into an empty batch.
- **QoS and preemption** (``preemption=True``, the default as in JAX):
  the queue admits by class (``batch`` < ``standard`` <
  ``interactive``), submit order within a class, passing over tenants
  whose token bucket (``qos=``, a ``qos.TokenLedger``) cannot pay their
  ``max_tokens`` yet. When a slot or blocks are short, a preemptible
  slot of a strictly lower class is SUSPENDED: the K/V it has written
  is indexed into the prefix trie, its pages release cache-retained,
  and the request re-queues with its original number. Its resume
  prefills prompt + emitted tokens, so the retained pages are a prefix
  hit and only the last block or two run (through K2 on the card).
  ``preemption=False`` is strict FIFO, never suspending.
- **KV-page migration** (``generate.py:1517-1665``, :2356-2500): a
  ``prefill_export`` runs the prefill only and returns the prompt's
  pages in the pool's native dtype with the first token
  (``serving.encode_kv_bundle`` puts them on the wire, ``:prefill``); an
  ``import_bundle`` on another engine copies them into free blocks and
  installs the slot straight into decode (``:attach``), so the
  continuation is the colocated engine's. ``role`` (``prefill`` |
  ``decode`` | ``both``) steers the router; every role stays
  capability-complete, and only a ``prefill`` engine refuses an import.
- **Tensor-sharded serving** (``mesh=``, ``generate.py:82-111``): the
  engine holds one parameter shard and one pool shard per position on
  the mesh's ``tensor`` axis (``compute/mesh.py``), each on that
  position's device. wq/wk/wv and w_gate/w_up are column-sharded, so
  every layer runs its column projections and its attention read PER
  SHARD, over the shard's ``kv_heads / tp`` heads of every block (a
  head-partitioned pool: N shards hold N× the blocks at one shard's
  budget). By default wo, w_down, the embedding and the LM head stay
  replicated, and ``_gathered`` moves the shards' raw activations to
  every device and joins them in shard order — a concatenation, no
  arithmetic, so the tokens are the unsharded engine's.
  ``row_shard=True`` shards wo/w_down rows and the embedding/head over
  vocab instead, and ``_psummed`` adds the partial products in shard
  order (the tolerance tier). Where JAX runs one ``shard_map`` program
  per step from one controller, this engine is that controller: it
  drives each shard on its device in turn, and does replicated work
  once per distinct device. All host state (trie, refcounts, tables,
  admission, preemption, migration) is the unsharded engine's; a
  1-shard mesh is the unsharded engine byte for byte. A mesh may name
  one device more than once (``["cpu"] * 4``, two shards on one card).

Where JAX donates the cache to its jitted programs
(``generate.py:828-838``), this engine updates the pool tensors in
place: a step writes its K/V rows straight into its shard's pool
(``_shards[i].cache``; ``self._cache`` at one shard). A
page a slot shares through the trie is never written again: every
write goes to a fresh page (an unindexed partial tail or a page past
the prompt), and after an exception mid-step ``_fail_everything``
drops the trie, since pages may hold partial writes.

Threading: one engine thread owns every device call (all kernel
launches happen there, on its current stream) and all slot state;
``submit``/``cancel``/``begin_drain`` are thread-safe.

Where the engine thread's time goes: ``stats`` books every loop
iteration in parts that together cover the thread's wall time —
``admit_seconds_total`` (the sweeps, admission and chunk bookkeeping,
less the prefill and import calls), ``prefill_seconds_total``,
``import_seconds_total``, the plain decode step as
``decode_prepare_seconds_total`` (the host's tables) →
``decode_launch_seconds_total`` (every launch through the argmax; on
one card the input's copy and the graph's replay, or the capture) →
``decode_sync_seconds_total`` (the wait for the tokens; the two make
``decode_seconds_total``) → ``decode_emit_seconds_total`` (the per-row
emission), and ``idle_wait_seconds_total`` (nothing to do) — beside
``iterations``, ``admissions`` and ``queue_wait_seconds_total``, and
the decode graph's ``decode_graph_replays``, ``decode_graph_captures``
and ``decode_graph_capture_seconds_total`` (inside the launches). The
same phases go into ``trace``, a flight-recorder ring (``engine.admit``,
``engine.prefill``, ``engine.import``, ``engine.decode.prepare``,
``.launch`` with ``.capture`` inside it, ``.sync``, ``.emit``,
``engine.wait``) on the wall clock the
profiler stamps device events on, served at ``/debug/traces?engine=``.
"""

import collections
import dataclasses
import logging
import os
import statistics
import threading
import time

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs import tracing
from ..qos import buckets as qos_lib
from . import attention as attn_lib
from . import device as device_lib
from . import mesh as mesh_lib
from . import quantize as quantize_lib
from . import serving as serving_lib
from . import sharding
from .models import transformer
from .ops import flash_attention as flash_ops
from .ops import paged_attention as paged_ops

log = logging.getLogger("kubeflow_tpu_torch.generate")

# the serving_generate_* families under the JAX package's names,
# labels, buckets and help text (one dashboard, one metrics hub for
# both)
_TOKENS_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_generate_tokens_total",
    "Generated tokens emitted (prefill first-tokens + decode steps) — "
    "rate() of this is the engine's tokens/sec",
    ("model",))
_PREFILL_SECONDS = obs_metrics.REGISTRY.histogram(
    "serving_generate_prefill_seconds",
    "One prefill program call (padded prompt forward + cache fill + "
    "first token), by prompt-length bucket economics",
    ("model",),
    buckets=(1e-3, 5e-3, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 5.0))
_PREFILL_CHUNKS_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_generate_prefill_chunks_total",
    "Prefill program calls by chunk economics: a monolithic prefill "
    "counts 1, a chunked long-prompt prefill counts one per chunk — "
    "rate() of this over prefills is the chunking factor, and a "
    "sustained high ratio with a low prefill_chunk knob means long "
    "prompts dominate admission",
    ("model",))
_DECODE_STEP_SECONDS = obs_metrics.REGISTRY.histogram(
    "serving_generate_decode_step_seconds",
    "One decode step advancing every occupied slot by one token",
    ("model",),
    buckets=(1e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 0.01, 0.025, 0.05, 0.1,
             0.5, 1.0))
_QUEUE_WAIT_SECONDS = obs_metrics.REGISTRY.histogram(
    "serving_generate_queue_wait_seconds",
    "Time a prompt waited in the admission queue, by outcome: "
    "admitted = the wait before its prefill launched, expired = the "
    "wait of a request whose deadline died in the queue (504 with no "
    "prefill) — without the expired series, overload queue time is "
    "survivorship-biased toward the requests that made it",
    ("model", "outcome"),
    buckets=(1e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0))
_SLOT_OCCUPANCY = obs_metrics.REGISTRY.histogram(
    "serving_generate_slot_occupancy_slots",
    "Occupied decode slots per decode step — the continuous-batching "
    "win is this distribution's mass near max_slots under mixed-"
    "length concurrent load (a drain-then-refill policy decays to 1)",
    ("model",),
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32))
_EVICTIONS_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_generate_evictions_total",
    "Decode-slot evictions by reason (eos | length | deadline | "
    "draining | cancelled | error) — mid-batch eviction is the "
    "mechanism of token-level continuous batching, so eos/length here "
    "are normal completions, not failures",
    ("model", "reason"))
_PREEMPTIONS_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_generate_preemptions_total",
    "Low-QoS slots SUSPENDED mid-decode to make room for a higher-"
    "class admission, by the resource the suspension freed (slot = "
    "no free decode slot, blocks = free slot but not enough cache "
    "blocks) — the suspended stream's pages are cache-retained and "
    "the request re-queues for a prefix-cached resume, so this is a "
    "pause, not a failure",
    ("model", "reason"))
_RESUME_PREFILL_TOKENS = obs_metrics.REGISTRY.counter(
    "serving_generate_resume_prefill_tokens_total",
    "Suffix tokens actually re-prefilled when a preempted request "
    "resumed — the cache-miss cost of resume. Compare with the "
    "resumed prompts' full extended length (prompt + tokens emitted "
    "before suspension): the gap is the prefill the retained pages "
    "saved",
    ("model",))
_PREFIX_HITS_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_generate_prefix_hits_total",
    "Admissions whose prompt matched >=1 full cached block in the "
    "prefix trie (the shared tokens skipped prefill entirely)",
    ("model",))
_PREFIX_MISSES_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_generate_prefix_misses_total",
    "Admissions with no cached-prefix match (full prefill paid); "
    "hits/(hits+misses) is the prefix-cache hit ratio",
    ("model",))
_PREFIX_TOKENS_SKIPPED_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_generate_prefix_tokens_skipped_total",
    "Prompt tokens whose prefill was skipped because their K/V was "
    "already cached — rate() of this is the prefill compute the "
    "prefix cache is saving",
    ("model",))
_PREFIX_CACHED_BLOCKS = obs_metrics.REGISTRY.gauge(
    "serving_generate_prefix_cached_blocks",
    "Physical cache blocks currently indexed by the prefix trie "
    "(reclaimable-at-zero-ref plus pinned-by-live-sequences)",
    ("model",))
_QUEUED_PROMPT_TOKENS = obs_metrics.REGISTRY.gauge(
    "serving_generate_queued_prompt_tokens",
    "Prompt tokens (plus already-generated context of preempted "
    "resumes) waiting in the admission queue — the token-aware "
    "autoscaling signal: request counts hide that one queued 4k "
    "prompt is more backlog than ten queued chat turns",
    ("model",))
_PREFIX_RECLAIMS_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_generate_prefix_reclaims_total",
    "Cached zero-ref blocks reclaimed LRU-on-demand to serve a new "
    "allocation — sustained rate means the pool is too small for the "
    "working set of shared prefixes",
    ("model",))
_SHARD_MESH_DEVICES = obs_metrics.REGISTRY.gauge(
    "serving_generate_shard_mesh_devices",
    "Tensor-parallel mesh size the generation engine is sharded over "
    "(1 = unsharded single-chip engine)",
    ("model",))
_SHARD_BLOCKS_PER_CHIP = obs_metrics.REGISTRY.gauge(
    "serving_generate_shard_cache_blocks_per_chip",
    "Per-chip HBM footprint of the head-partitioned KV block pool in "
    "single-chip block units (num_blocks / mesh size) — at a fixed "
    "per-chip budget the POOL grows linearly with the mesh, which is "
    "the cache-capacity win of sharded serving",
    ("model",))
_SHARD_COLLECTIVE_SHARE = obs_metrics.REGISTRY.gauge(
    "serving_generate_shard_collective_share",
    "Measured share of the decode step spent in cross-chip "
    "collectives (the per-layer activation all-gathers), from "
    "measure_collective_share() calibration — 0.0 until calibrated "
    "or when the engine is unsharded",
    ("model",))
_SPEC_PROPOSED_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_generate_spec_proposed_tokens_total",
    "Draft-model tokens proposed to the speculative verify step "
    "(clamped per slot to the remaining generation budget) — the "
    "denominator of the acceptance ratio",
    ("model",))
_SPEC_ACCEPTED_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_generate_spec_accepted_tokens_total",
    "Draft tokens the target's argmax confirmed (the longest "
    "draft==target prefix per verify step) — rate() over the "
    "proposed rate is the live acceptance ratio",
    ("model",))
_SPEC_ACCEPTANCE_RATIO = obs_metrics.REGISTRY.gauge(
    "serving_generate_spec_acceptance_ratio",
    "Cumulative accepted/proposed draft-token ratio — the "
    "speculative speedup is ~(1 + k*ratio) tokens per target "
    "forward, so a sustained low ratio means the draft/target pair "
    "(or k) is mis-sized",
    ("model",))
_ATTN_BACKEND = obs_metrics.REGISTRY.gauge(
    "serving_generate_attn_backend",
    "Info-style gauge: 1 for the engine's selected paged-attention "
    "read backend (gather | paged | paged-kernel), 0 for the others "
    "— join on the backend label to see which read path a fleet's "
    "engines run",
    ("model", "backend"))
_ATTN_BYTES_TOTAL = obs_metrics.REGISTRY.counter(
    "serving_generate_attn_bytes_read_total",
    "Analytic KV-cache bytes touched by the attention reads (decode, "
    "verify, cached-prefill prefix), derived from block occupancy: "
    "the gather backend is charged the full padded pool width per "
    "step while the paged backends are charged only occupied blocks "
    "— rate() per token is the decode-bandwidth figure the paged "
    "read path exists to shrink",
    ("model", "backend"))
_TOKENS_PER_STEP = obs_metrics.REGISTRY.histogram(
    "serving_generate_tokens_per_step",
    "Tokens a sequence emitted per decode/verify step — exactly 1 "
    "on the plain engine, 1..k+1 under speculative decoding; "
    "normalize serving_generate_decode_step_seconds by this "
    "distribution's mean to keep per-token latency interpretable",
    ("model",),
    buckets=(1, 2, 3, 4, 5, 6, 8, 12, 16))
_TTFT_SECONDS = obs_metrics.REGISTRY.histogram(
    "serving_generate_ttft_seconds",
    "Time to first token: request admission (submit) to the first "
    "emitted token, decomposing as queue wait + prefill (the "
    "generate.queue_wait / generate.prefill trace phases) — the "
    "user-felt responsiveness figure of a streamed generation",
    ("model",),
    buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
             10.0))
_INTER_TOKEN_SECONDS = obs_metrics.REGISTRY.histogram(
    "serving_generate_inter_token_seconds",
    "Gap between consecutive token EMISSION EVENTS of one sequence "
    "(first gap starts at the first token): one sample per decode "
    "step, and one per speculative verify round — the 1..k+1 tokens "
    "a verify round accepts share one emission event, so a spec "
    "burst counts its round gap ONCE instead of k+1 zero-gaps",
    ("model",),
    buckets=(5e-4, 1e-3, 2.5e-3, 5e-3, 0.01, 0.025, 0.05, 0.1, 0.25,
             1.0))
_EMITTED_TOKENS = obs_metrics.REGISTRY.histogram(
    "serving_generate_emitted_tokens",
    "Tokens emitted per finished request (0 for queue-side failures "
    "that never reached prefill) — the per-request totals behind the "
    "engine's tokens/sec",
    ("model",),
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 1024))
_KV_MIGRATED_BYTES = obs_metrics.REGISTRY.counter(
    "serving_kv_migrated_bytes_total",
    "KV-cache page bytes EXPORTED as prefill/decode migration bundles "
    "(counted at export, in the pool's native dtype — int8 pages ship "
    "with their float32 scales, both included here), by pool dtype. "
    "A prefill-role replica's rate() of this is the bytes/sec the "
    "x-tensor wire carries into the decode pool",
    ("model", "dtype"))
_KV_MIGRATION_SECONDS = obs_metrics.REGISTRY.histogram(
    "serving_kv_migration_seconds",
    "Bundle received -> imported slot live in decode (block "
    "allocation + native-dtype page memcpy + trie seed + admission), "
    "observed on the IMPORTING engine — the decode-side half of the "
    "two-hop migration latency (the export half rides "
    "serving_generate_prefill_seconds on the prefill replica)",
    ("model",),
    buckets=(1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0))
_KV_IMPORT_REJECTIONS = obs_metrics.REGISTRY.counter(
    "serving_kv_import_rejections_total",
    "Page bundles REFUSED by the importing engine, by reason "
    "(block_size | geometry | dtype | vocab | capacity | role | mesh) "
    "— the router treats any rejection as a transfer failure and "
    "falls back to colocated serving, so a nonzero rate here with "
    "zero 5xx is the fallback path working as designed",
    ("model", "reason"))
_GEN_ROLE = obs_metrics.REGISTRY.gauge(
    "serving_generate_role",
    "Disaggregation role of this engine, one-hot over (prefill | "
    "decode | both) — joins the serving_generate_* families to a "
    "role track so the hub's /debug/generate can split prefill-queue "
    "pressure from decode-slot occupancy per role",
    ("model", "role"))

#: slot lifecycle timeline ring size (snapshot ``timeline``)
_TIMELINE_EVENTS = int(os.environ.get("GEN_TIMELINE_EVENTS", "256"))
#: raw TTFT / inter-token-gap samples kept for token_latency_stats
_LATENCY_SAMPLES = 4096
#: engine-iteration spans kept in the flight-recorder ring (``trace``)
_ITERATION_SPANS = 16384
#: the launch counters of the kernels a plain decode step runs (K1,
#: K1-i8): a replay adds the launches its capture counted
_LAUNCH_COUNTERS = ((paged_ops.paged_decode_attention, "launches"),
                    (paged_ops.paged_decode_attention, "launches_i8"))
#: one captured plain decode step: what it bakes in (``key``), its static
#: input and outputs, and the launches a replay adds to each counter
_DecodeGraph = collections.namedtuple(
    "_DecodeGraph", "key graph inputs outputs launches")

ATTN_BACKENDS = ("gather", "paged", "paged-kernel")

#: the engine raises the serving plane's classes, which the transport
#: maps to 503 and 504
DrainingError = serving_lib.DrainingError
DeadlineExceededError = serving_lib.DeadlineExceededError

ROLES = ("prefill", "decode", "both")


class MeshShapeError(ValueError):
    """The generation mesh cannot shard this model (``generate.py:400``):
    the tensor axis must divide ``n_heads`` AND ``kv_heads`` (heads are
    partitioned whole), every non-tensor mesh axis must be size 1, and
    ``row_shard`` needs it to divide ``vocab_size``. Raised at
    construction, as one named error."""


class KVImportError(ValueError):
    """A KV-page bundle the importing engine cannot admit
    (``generate.py:410``). ``reason`` is the rejection class
    (``block_size`` | ``geometry`` | ``dtype`` | ``vocab`` | ``capacity``
    | ``role`` | ``mesh``), booked on
    ``serving_kv_import_rejections_total`` before raising; the transport
    answers 400 (a ValueError), and the router falls back to colocated
    serving."""

    def __init__(self, reason, message):
        super().__init__(message)
        self.reason = reason


class GenerationHandle:
    """One submitted prompt's lifecycle: the engine appends generated
    tokens and fires the callbacks from ITS thread; ``wait()`` /
    ``result()`` serve blocking callers."""

    __slots__ = ("prompt", "max_tokens", "eos_id", "deadline",
                 "on_token", "on_done", "rt", "out_tokens", "reason",
                 "error", "cancelled", "cancel_reason", "enqueued",
                 "enqueued_w", "prefix_tokens_skipped",
                 "prefill_seconds", "spec_rounds", "spec_proposed",
                 "spec_accepted", "spec_wire", "logits", "seq",
                 "ttft_s", "token_times", "itg_gaps", "last_emit",
                 "admitted_w", "tenant", "qos_class", "preemptible",
                 "on_event", "suspended", "preemptions",
                 "resume_prefill_tokens", "export_kv", "kv_bundle",
                 "_qos_charged", "_qos_deferred", "_engine", "_done")

    def __init__(self, prompt, max_tokens, eos_id, deadline, on_token,
                 on_done, rt):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.eos_id = eos_id
        self.deadline = deadline  # absolute time.monotonic, or None
        self.on_token = on_token
        self.on_done = on_done
        self.rt = rt              # tracing.RequestTrace of the request
        self.out_tokens = []
        self.reason = None        # eos|length|deadline|draining|...
        self.error = None         # the finish error the transport maps
        self.cancelled = False
        self.cancel_reason = "cancelled"
        self.prefix_tokens_skipped = 0
        self.prefill_seconds = None
        self.spec_rounds = 0      # verify rounds this request rode
        self.spec_proposed = 0    # draft tokens proposed for it
        self.spec_accepted = 0    # ... and accepted
        self.spec_wire = None     # X-Spec-Acceptance frozen at prefill
        self.logits = []          # per-emitted-token fp32 logits, filled
        #                           only on a debug_logits engine
        self.seq = 0              # engine-assigned request number
        self.ttft_s = None        # submit -> first token, seconds
        self.token_times = []     # wall clock of every emitted token
        self.itg_gaps = []        # seconds between emission events (a
        #                           verify round's burst is one event)
        self.last_emit = None     # perf_counter of the last event
        self.admitted_w = None    # wall clock at admission
        self.tenant = None        # X-Tenant attribution (the ledger and
        #                           serving_qos_*), None = anonymous
        self.qos_class = qos_lib.DEFAULT_CLASS   # admission priority
        #                           and preemption rank
        self.preemptible = True   # may a higher class suspend it?
        self.on_event = None      # (event, attrs) for "suspended" /
        #                           "resumed", relayed as event frames
        self.suspended = False    # re-queued, pages cache-retained,
        #                           waiting for its resume
        self.preemptions = 0      # times this request was suspended
        self.resume_prefill_tokens = 0   # suffix tokens re-prefilled
        #                           over all its resumes
        self.export_kv = False    # prefill only: the pages export as a
        #                           bundle (reason "exported")
        self.kv_bundle = None     # the exported bundle (export side), or
        #                           the bundle to import until admitted
        self._qos_charged = False  # the ledger charged at first
        #                            admission (a resume never again)
        self._qos_deferred = False  # one deferral booked a queue stint
        self.enqueued = time.perf_counter()
        self.enqueued_w = time.time()
        self._engine = None
        self._done = threading.Event()

    def wait(self, timeout=None):
        return self._done.wait(timeout)

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """→ ``(generated_tokens, finish_reason)``; raises the finish
        error when the request failed before emitting any token. On a
        ``timeout`` expiry the request is cancelled (reason
        ``abandoned``) before ``TimeoutError`` raises, so an abandoned
        caller never leaves it burning a slot."""
        if not self._done.wait(timeout):
            if self._engine is not None:
                self._engine.cancel(self, reason="abandoned")
            raise TimeoutError("generation did not finish in time")
        if self.error is not None and not self.out_tokens:
            raise self.error
        return list(self.out_tokens), self.reason


class _Slot:
    """One occupied decode slot (engine-thread-only state). A slot
    admitted under chunked prefill starts with ``prefilling=True``: it
    holds its slot and reservation but stays out of decode and verify
    batches, and out of preemption, until ``_advance_prefills`` has
    written its whole prompt."""

    __slots__ = ("handle", "blocks", "length", "last_token", "reserve",
                 "decode_start_w", "prefilling", "pf_written",
                 "pf_matched", "pf_resuming", "pf_chunks", "pf_t0",
                 "pf_t0w")

    def __init__(self, handle, blocks, length, last_token, reserve):
        self.handle = handle
        self.blocks = blocks          # physical block ids, logical order
        self.length = length          # positions whose K/V are cached
        self.last_token = last_token  # next decode step's input
        self.reserve = reserve        # worst-case blocks held at admit
        self.decode_start_w = time.time()
        self.prefilling = False       # chunked prefill in progress
        self.pf_written = 0           # prompt tokens whose K/V are cached
        self.pf_matched = ()          # trie nodes pinned at admission
        self.pf_resuming = False      # this admission is a resume
        self.pf_chunks = 0            # prefill chunks run so far
        self.pf_t0 = 0.0              # perf_counter at admission
        self.pf_t0w = 0.0             # wall clock at admission


class _PrefixNode:
    """One edge of the prefix trie: ``key`` is the full block of prompt
    token ids whose K/V page ``block`` holds, given the path from the
    root. Position ``i``'s K/V depends only on tokens ``0..i``, so every
    prompt walking the same path reads the same pages."""

    __slots__ = ("key", "block", "parent", "children", "last_used")

    def __init__(self, key, block, parent):
        self.key = key             # tuple of block_size token ids
        self.block = block         # physical page holding the K/V
        self.parent = parent
        self.children = {}
        self.last_used = time.monotonic()


class _Shard:
    """One position on the mesh's ``tensor`` axis (the whole model when
    there is no mesh): its device, its params (its column pieces, and
    the replicated leaves it shares with every shard on its device), the
    per-layer views of them, the fp32 LM head where this shard computes
    logits (None elsewhere), and its slice of the pool: ``pool`` with
    the sink block at its end, ``cache`` the views of its
    ``num_blocks`` usable blocks."""

    __slots__ = ("device", "params", "layers", "head", "pool", "cache")

    def __init__(self, device, params, layers, head):
        self.device = device
        self.params = params
        self.layers = layers
        self.head = head
        self.pool = self.cache = None


class _MeshLayer:
    """One layer's hooks for ``transformer.layer_core``'s sharded form
    (``generate.py:3230``): each shard's layer params, the norms once
    per device (the replicated scales of that device's first shard),
    and the row projections through the engine's ``_row_proj``."""

    def __init__(self, engine, layer):
        self.engine, self.layer = engine, layer
        self.layers = [sh.layers[layer] for sh in engine._shards]

    def norm(self, xs, name):
        e = self.engine
        hs = {d: transformer._rmsnorm(x, e._lead[d].layers[self.layer][name],
                                      e.config.norm_eps)
              for d, x in xs.items()}
        return [hs[sh.device] for sh in e._shards]

    def project(self, xs, pieces, name):
        return self.engine._row_proj(xs, pieces, self.layer, name)


class GenerationEngine:
    """Autoregressive decode server for one TransformerLM.

    ``params``/``config`` are the model (``transformer.init_params``
    layout, stacked or per-layer-list ``layers``; fp32 masters are cast
    to the compute dtype once, on ``device``). Knobs:

    - ``max_slots``: decode-batch width (resident sequences),
    - ``block_size`` / ``num_blocks``: pool geometry (default pool =
      every slot at full ``max_context``),
    - ``max_context``: prompt + generated ceiling per sequence,
    - ``eos_id``: default stop token (per-request override),
    - ``name`` / ``version``: the served model's name (the metric label)
      and version (``X-Served-Version``),
    - ``admission``: ``"continuous"`` (token-level continuous batching,
      the default) or ``"drain"`` (drain-then-refill: admit only into
      an EMPTY batch — the baseline the continuous policy is measured
      against),
    - ``prefix_cache``: radix-trie prefix KV reuse (default on, as in
      JAX); ``False`` frees pages at eviction and prefills every prompt
      whole,
    - ``prefill_chunk``: cap every prefill call at this many prompt
      tokens (rounded up to a block multiple) and interleave the chunks
      with decode steps; ``None``/0 = monolithic prefill,
    - ``draft_params``/``draft_config``/``spec_k``: speculative
      decoding — the draft proposes up to ``spec_k`` tokens per slot per
      round and one target forward verifies them; ``spec_k=0`` (the
      default) or no draft is the plain engine. The draft shares the
      target's vocab,
    - ``debug_logits``: handles collect each emitted token's fp32
      logits (``compute/conformance.py``); needs ``prefix_cache=False``,
      no draft and monolithic prefill,
    - ``kv_dtype``: ``None`` (the pool in the compute dtype) or
      ``"int8"`` (int8 pages with fp32 per-(position, head) scales;
      ``generate.py:606``),
    - ``qos``: a ``qos.TokenLedger`` (or None): admission charges a
      tenant's bucket its ``max_tokens`` once, deferring (not failing)
      a request its bucket cannot pay yet, and ``submit`` takes a
      tenant's class from it,
    - ``preemption``: priority admission by QoS class and preemptible
      decoding (default on, as in JAX); ``False`` is strict FIFO that
      never suspends a slot,
    - ``role``: ``"both"`` (default), ``"prefill"`` or ``"decode"`` — the
      disaggregation role the router and the per-role metrics read; a
      ``"prefill"`` engine refuses ``import_bundle`` (reason ``role``),
      and is otherwise as capable as the others,
    - ``attn_backend``: the pool reads — ``"paged"`` (default) and
      ``"paged-kernel"`` both read through ``ops.paged_attention``
      (kernels K1 and K2 on the card, their plain versions on the CPU);
      ``"gather"`` materializes the ``[S, T]`` context and runs
      ``attention.decode_attention`` / ``chunk_attention``, the
      conformance reads,
    - ``mesh``: a ``mesh.mesh_for_generation(tensor=N)`` mesh shards
      the engine over its ``tensor`` axis (see the module docstring);
      the mesh names the devices, so ``device`` stays None,
    - ``row_shard``: with a mesh, shard wo/w_down rows and the
      embedding/LM head over vocab, summing partial products (the
      tolerance tier) instead of gathering raw activations,
    - ``device``: None → the card (raises without CUDA); ``"cpu"`` runs
      the plain versions of the kernels.
    """

    def __init__(self, params, config, *, max_slots=4, block_size=16,
                 max_context=None, num_blocks=None, name="model",
                 version=1, eos_id=None, default_max_tokens=64,
                 admission="continuous", prefix_cache=True,
                 draft_params=None, draft_config=None, spec_k=0,
                 debug_logits=False, attn_backend="paged",
                 prefill_chunk=None, kv_dtype=None, qos=None,
                 preemption=True, role="both", mesh=None, row_shard=False,
                 device=None):
        if config.moe_experts and not config.moe_dropless:
            raise ValueError(
                "GenerationEngine serves dropless MoE only: a capacity "
                "dispatch drops tokens, which is another model")
        if (config.extended or config.moe_experts) and (
                mesh is not None or draft_params is not None
                or attn_backend == "gather"):
            raise ValueError(
                "a mixture of experts or the AFMoE fields "
                f"({', '.join(config.extended) or 'moe_experts'}) are "
                "served unsharded, with no draft, through the paged "
                "reads")
        if admission not in ("continuous", "drain"):
            raise ValueError(
                f"admission must be 'continuous' or 'drain', got "
                f"{admission!r}")
        if attn_backend not in ATTN_BACKENDS:
            raise ValueError(
                f"attn_backend must be 'gather', 'paged' or "
                f"'paged-kernel', got {attn_backend!r}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        if role not in ROLES:
            raise ValueError(
                f"role must be 'prefill', 'decode' or 'both', got "
                f"{role!r}")
        self.kv_dtype = kv_dtype
        self.spec_k = int(spec_k)
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if self.spec_k > 0 and draft_params is None:
            raise ValueError(
                "spec_k > 0 needs a draft model (draft_params + "
                "draft_config); spec_k=0 disables speculation")
        if draft_params is not None and draft_config is None:
            raise ValueError("draft_params needs its draft_config")
        # speculation is on only with both a draft and k > 0; otherwise
        # none of the draft/verify machinery is built
        self._spec_on = draft_params is not None and self.spec_k > 0
        if self._spec_on and draft_config.vocab_size != config.vocab_size:
            raise ValueError(
                f"draft vocab_size {draft_config.vocab_size} must equal "
                f"the target's {config.vocab_size}: accepted tokens are "
                f"compared by id")
        if self._spec_on and draft_config.moe_experts:
            raise ValueError(
                "the draft must be a dense TransformerLM (no MoE, no "
                "pipeline parallelism)")
        self.mesh = mesh
        self.tp = 1
        if mesh is not None:
            sizes = dict(mesh.shape)
            self.tp = int(sizes.get(mesh_lib.TENSOR, 1))
            nontrivial = {a: s for a, s in sizes.items()
                          if s != 1 and a != mesh_lib.TENSOR}
            if nontrivial:
                raise MeshShapeError(
                    f"generation mesh may only shard the "
                    f"'{mesh_lib.TENSOR}' axis; got non-trivial axes "
                    f"{nontrivial} (use mesh_for_generation(tensor=N))")
            if config.n_heads % self.tp or config.kv_heads % self.tp:
                raise MeshShapeError(
                    f"mesh tensor axis {self.tp} must divide n_heads="
                    f"{config.n_heads} and kv_heads={config.kv_heads}:"
                    f" attention heads are partitioned whole per chip "
                    f"(pick a tensor size that divides both, or adjust"
                    f" the model's head counts)")
            if device is not None:
                raise ValueError(
                    "mesh= names the engine's devices; leave device= "
                    "unset")
        # row-sharded projections (generate.py:730-750): opt-in, the
        # tolerance tier; the default sharded engine gathers raw
        # activations and keeps the tokens exact
        self.row_shard = bool(row_shard)
        if self.row_shard:
            if mesh is None:
                raise ValueError(
                    "row_shard=True needs a mesh (it shards wo/w_down/"
                    "embed/head over the tensor axis)")
            if config.vocab_size % self.tp:
                raise MeshShapeError(
                    f"row_shard needs the mesh tensor axis {self.tp} "
                    f"to divide vocab_size={config.vocab_size}: the "
                    f"embedding table and LM head partition over vocab "
                    f"rows/columns whole")
        self.device = (mesh.devices[0] if mesh is not None
                       else device_lib.resolve(device))
        self.config = config
        self.name = name
        self.version = version
        self.admission = admission
        # the tenant ledger (None: every tenant unconstrained) and the
        # QoS admission order with preemptible decoding; preemption
        # False is strict FIFO, never suspending (generate.py:769-777)
        self._qos = qos
        self.preemption = bool(preemption)
        # the disaggregation role steers the router (prefill replicas get
        # :prefill, decode replicas :attach); every role serves :generate
        # too, since the router falls back to colocated serving
        # (generate.py:752-764)
        self.role = role
        self.attn_backend = attn_backend
        self.eos_id = eos_id
        self.default_max_tokens = int(default_max_tokens)
        self.max_slots = int(max_slots)
        self.block_size = int(block_size)
        # rounded up to a block multiple: chunks fill whole fresh
        # blocks, so every chunk starts block-aligned
        self.prefill_chunk = (-(-int(prefill_chunk) // self.block_size)
                              * self.block_size) if prefill_chunk else 0
        self.max_context = int(max_context or config.max_seq)
        self.blocks_per_slot = -(-self.max_context // self.block_size)
        self.num_blocks = int(num_blocks
                              or self.max_slots * self.blocks_per_slot)
        if self.num_blocks < 1:
            raise ValueError(
                f"num_blocks must be >= 1, got {self.num_blocks}")
        # each shard stores kv_heads/tp heads of every block: one shard's
        # share costs the memory of num_blocks/tp single-chip blocks
        # (generate.py:807-814)
        self.per_chip_blocks = (
            self.num_blocks // self.tp
            if self.num_blocks % self.tp == 0
            else round(self.num_blocks / self.tp, 2))
        self.prefix_cache = bool(prefix_cache)
        self.debug_logits = bool(debug_logits)
        if self.debug_logits and (self.prefix_cache or self._spec_on
                                  or self.prefill_chunk):
            raise ValueError(
                "debug_logits is the plain-path tolerance-conformance "
                "probe (compute/conformance.py): it requires "
                "prefix_cache=False, no draft model and monolithic "
                "prefill (a mesh IS allowed — it is how the sharded "
                "paths are graded under the tolerance tier)")
        self._shards = []
        self._load_weights(params)
        self._make_cache()
        # the plain decode step's packed host input (_step_views) and its
        # tokens, pinned on a card: one non-blocking copy in, one out
        S, pin = self.max_slots, self.device.type == "cuda"
        self._step_in = torch.zeros(S * self.blocks_per_slot + 5 * S,
                                    dtype=torch.int32, pin_memory=pin)
        self._step_np = self._step_in.numpy()
        # (an expert model adds the step's active-expert tally after the
        # tokens: it rides the tokens' copy)
        self._moe = bool(config.moe_experts)
        self._next_in = torch.zeros(S + self._moe, dtype=torch.int64,
                                    pin_memory=pin)
        self._step_tally = (0, 0, 0)
        self._next_np = self._next_in.numpy()
        # every shard on one card: the step is one CUDA graph replay
        self._graphable = (len(self._devices) == 1
                           and self.device.type == "cuda")
        self._graph = None
        self._elide_collectives = False     # measure_collective_share
        self.draft_config = draft_config if self._spec_on else None
        if self._spec_on:
            # the draft runs once, on the first shard's device: the
            # proposals go to the host, so copies on every device would
            # compute the same tokens again
            (self.draft_params, self._draft_head,
             self._draft_layers) = self._load(draft_params, draft_config)
            # the draft's dense per-slot cache spans the same per-slot
            # capacity as the paged target pool
            self._draft_ctx = self.blocks_per_slot * self.block_size
            self._draft_cache = self._make_draft_cache()
        else:
            self.draft_params = None
        # analytic bytes per cache block touched by one layer's read
        # (k + v, plus the int8 scales) × layers — what
        # stats["attn_bytes_read"] accumulates (generate.py:891-899)
        itemsize = 1 if kv_dtype == "int8" else torch.empty(
            (), dtype=config.compute_dtype).element_size()
        per_block = (self.block_size * config.kv_heads * config.head_dim
                     * itemsize * 2)
        if kv_dtype == "int8":
            per_block += self.block_size * config.kv_heads * 4 * 2
        self._block_read_bytes = per_block * config.n_layers
        self._free = list(range(self.num_blocks))
        self._slots = [None] * self.max_slots
        self._queue = collections.deque()
        self._cond = threading.Condition()
        for r in ROLES:
            _GEN_ROLE.labels(name, r).set(1 if r == self.role else 0)
        _SHARD_MESH_DEVICES.labels(name).set(self.tp)
        _SHARD_BLOCKS_PER_CHIP.labels(name).set(self.num_blocks / self.tp)
        for b in ATTN_BACKENDS:
            _ATTN_BACKEND.labels(name, b).set(1 if b == attn_backend else 0)
        _QUEUED_PROMPT_TOKENS.labels(name).set(0)
        # prefix trie state, every mutation under self._cond:
        # - _ref[b]: block-table memberships plus in-flight prefill
        #   holds; an indexed block at ref 0 is cached (reclaimable),
        #   an unindexed one at ref 0 is on the free list
        # - _root/_node_by_block: the trie over full prompt blocks;
        #   _inflight: blocks held by the prefill in progress
        # - _reclaimable: zero-ref LEAF nodes in became-reclaimable
        #   (LRU) order; _n_reclaimable counts every zero-ref cached
        #   block, leaves and interior nodes
        self._ref = [0] * self.num_blocks
        self._root = _PrefixNode(None, None, None)
        self._node_by_block = {}
        self._inflight = []
        self._reclaimable = {}
        self._n_reclaimable = 0
        self._draining = False
        self._stop = False
        self._step_sleep = 0.0    # test knob: fake device time per step
        self._seq = 0             # request numbering for the timeline
        # bounded slot-lifecycle ring (snapshot "timeline"); appends are
        # engine-thread-only
        self._timeline = collections.deque(maxlen=_TIMELINE_EVENTS)
        # engine-wide raw TTFT / gap samples (token_latency_stats)
        self._ttft_samples = collections.deque(maxlen=_LATENCY_SAMPLES)
        self._itg_samples = collections.deque(maxlen=_LATENCY_SAMPLES)
        self.stats = {"prefills": 0, "prefill_chunks": 0,
                      "decode_steps": 0, "decode_token_slots": 0,
                      "tokens": 0, "peak_occupancy": 0,
                      "prefill_seconds_total": 0.0,
                      "decode_seconds_total": 0.0, "attn_bytes_read": 0,
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefix_tokens_skipped": 0, "prefix_reclaims": 0,
                      "collective_share": 0.0,
                      "spec_rounds": 0, "spec_proposed": 0,
                      "spec_accepted": 0, "preemptions": 0, "resumes": 0,
                      "resume_prefill_tokens": 0, "qos_deferrals": 0,
                      "kv_exports": 0, "kv_imports": 0,
                      "kv_bytes_migrated": 0, "kv_import_rejections": 0,
                      # the engine thread's wall time, by phase (module
                      # docstring)
                      "iterations": 0, "admit_seconds_total": 0.0,
                      "import_seconds_total": 0.0,
                      "decode_prepare_seconds_total": 0.0,
                      "decode_launch_seconds_total": 0.0,
                      "decode_sync_seconds_total": 0.0,
                      "decode_emit_seconds_total": 0.0,
                      "idle_wait_seconds_total": 0.0,
                      "admissions": 0, "queue_wait_seconds_total": 0.0,
                      # the plain decode step's CUDA graph
                      "decode_graph_replays": 0, "decode_graph_captures": 0,
                      "decode_graph_capture_seconds_total": 0.0,
                      # the prefill calls' work (module docstring)
                      "prefill_tokens_total": 0,
                      "prefill_attn_pairs_total": 0,
                      "prefill_cached_tokens_total": 0,
                      "prefill_cached_prefix_total": 0,
                      "prefill_cached_attn_pairs_total": 0}
        if self._moe:
            # per expert layer call, prefill and decode (module docstring)
            self.stats.update(moe_calls=0, moe_assignments_total=0,
                              moe_padded_rows_total=0,
                              moe_active_experts_total=0,
                              moe_decode_calls=0,
                              moe_decode_assignments_total=0,
                              moe_decode_active_experts_total=0)
        self.thread = threading.Thread(target=self._loop, daemon=True,
                                       name=f"generate-{name}")
        self.trace = tracing.TraceBuffer(_ITERATION_SPANS,
                                         thread=self.thread.name)
        self.thread.start()

    @staticmethod
    def _stacked(params):
        """A per-layer-list ``layers`` stacked, as JAX stacks it
        (``generate.py:801-806``)."""
        layers = params["layers"]
        if isinstance(layers, (list, tuple)):
            params = {**params, "layers": {
                k: torch.stack([lp[k] for lp in layers])
                for k in layers[0]}}
        return params

    def _load(self, params, config):
        """Model params → (compute-dtype params on the engine's device,
        the fp32 LM head, per-layer views). The head is widened to fp32
        once: exact, so logits are the fp32 sums of compute-dtype
        products (JAX's ``preferred_element_type``); a no-op view for an
        fp32 model."""
        p = transformer.cast_params(self._stacked(params),
                                    config.compute_dtype, self.device)
        layers = p["layers"]
        if "we_gate" in layers:
            # the experts' gate|up joined once, as the grouped matmul
            # reads it (the AFMoE layout holds it so already)
            layers = dict(layers)
            layers["we_gu"] = torch.cat(
                [layers.pop("we_gate"), layers.pop("we_up")], dim=-1)
            p = {**p, "layers": layers}
        return (p, p["head"].float(),
                [transformer.layer_params(p, i)
                 for i in range(config.n_layers)])

    def _param_axes(self):
        """Logical axes of the engine's stacked param layout
        (``generate.py:964``): the platform rules shard the attention
        heads and the MLP hidden dim over ``tensor``; by default wo,
        w_down, the embedding and the LM head are replicated (``None``),
        so the only cross-shard traffic is ``_gathered``'s raw
        activations. ``row_shard`` keeps the rules as they are: wo rows
        over heads, w_down rows over mlp, embed/head over vocab."""
        cfg = dataclasses.replace(self.config, scan_layers=True)
        axes = transformer.logical_axes(cfg)
        if not self.row_shard:
            axes["embed"] = axes["head"] = None
            axes["layers"] = dict(axes["layers"], wo=None, w_down=None)
        return axes

    def _load_weights(self, params):
        """The target's weights onto the shards (``_load_shards``) and
        what the steps read of them; each shard keeps its pool. A reload
        gives the weights new storage, so the next plain decode step
        captures its graph again (``_graph_key``)."""
        pools = [(sh.pool, sh.cache) for sh in self._shards]
        self._shards = self._load_shards(params)
        for sh, (pool, cache) in zip(self._shards, pools):
            sh.pool, sh.cache = pool, cache
        # the distinct devices in shard order, and the first shard on
        # each: replicated work runs once per device, on that shard's
        # copies of the replicated leaves
        self._devices = list(dict.fromkeys(sh.device for sh in self._shards))
        self._lead = {}
        for sh in self._shards:
            self._lead.setdefault(sh.device, sh)
        self.params = self._shards[0].params
        self._mesh_layers = [_MeshLayer(self, i)
                             for i in range(self.config.n_layers)]

    def _load_shards(self, params):
        """The target's params → one :class:`_Shard` per mesh position
        (``_shard_params``, ``generate.py:1043``), or one holding the
        whole model without a mesh. The fp32 head is made where logits
        are computed: on the first shard, or on every shard's vocab
        slice under ``row_shard``."""
        if self.mesh is None:
            p, head, layers = self._load(params, self.config)
            return [_Shard(self.device, p, layers, head)]
        p = transformer.cast_params(self._stacked(params),
                                    self.config.compute_dtype)
        trees = sharding.shard_tree(p, self.mesh, self._param_axes())
        return [_Shard(dev, t,
                       [transformer.layer_params(t, i)
                        for i in range(self.config.n_layers)],
                       t["head"].float() if self.row_shard or i == 0
                       else None)
                for i, (dev, t) in enumerate(zip(self.mesh.devices, trees))]

    def _make_cache(self):
        """Each shard's zeroed pool slice (``_make_cache``,
        ``generate.py:997``): ``(k, v)``, each ``[layers, num_blocks,
        block_size, kv_heads / tp, head_dim]`` in the compute dtype;
        int8: ``(k, v, k_scale, v_scale)`` with int8 zeros and fp32 ones
        ``[..., kv_heads / tp, 1]`` (``generate.py:1008-1012``). The pool
        is head-partitioned (``_cache_specs``, :989): shard i holds heads
        ``[i kv/tp, (i+1) kv/tp)`` of every block, scales included. Each
        tensor holds one block more, the sink (block ``num_blocks``) that
        the plain decode step's idle rows write; ``cache`` views the
        blocks without it, as JAX's pool is shaped."""
        c = self.config
        shape = (c.n_layers, self.num_blocks + 1, self.block_size,
                 c.kv_heads // self.tp, c.head_dim)
        for sh in self._shards:
            dev = sh.device
            if self.kv_dtype == "int8":
                sh.pool = (
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.zeros(shape, dtype=torch.int8, device=dev),
                    torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                               device=dev),
                    torch.ones(shape[:-1] + (1,), dtype=torch.float32,
                               device=dev))
            else:
                sh.pool = tuple(
                    torch.zeros(shape, dtype=c.compute_dtype, device=dev)
                    for _ in range(2))
            sh.cache = tuple(p[:, :self.num_blocks] for p in sh.pool)

    @property
    def _cache(self):
        """The pool at one shard: the tuple the steps write. Under a
        mesh each shard holds its own (``_shards[i].cache``) and there is
        no single pool: this raises, so no engine path can copy the
        whole pool by reading it."""
        if self.tp > 1:
            raise RuntimeError(
                f"a {self.tp}-shard engine has one pool per shard "
                f"(_shards[i].cache); joined_pool_copy() copies them")
        return self._shards[0].cache

    def joined_pool_copy(self):
        """A host copy of the whole pool in the single-chip layout
        ``[layers, num_blocks, block_size, kv_heads, head_dim]``, the
        shards' heads joined in order — what JAX's ``np.asarray`` of its
        sharded pool gives. It moves every block of every shard, so the
        engine never calls it: it is for comparing two engines' pools
        (an export copies only its own blocks)."""
        return tuple(torch.cat([sh.cache[i].cpu() for sh in self._shards],
                               dim=3)
                     for i in range(len(self._shards[0].cache)))

    def _make_draft_cache(self):
        """The draft's dense per-slot cache ``(k, v)``, each ``[layers,
        slot, position, kv_heads, head_dim]`` (``generate.py:1022``).
        Pure scratch: rollback after a verify is a host-side length
        truncation, and nothing in it is shared."""
        c = self.draft_config
        shape = (c.n_layers, self.max_slots, self._draft_ctx, c.kv_heads,
                 c.head_dim)
        return tuple(torch.zeros(shape, dtype=c.compute_dtype,
                                 device=self.device) for _ in range(2))

    # ------------------------------------------------------ public API

    def submit(self, tokens, max_tokens=None, eos_id=None,
               deadline=None, on_token=None, on_done=None, rt=None,
               tenant=None, qos_class=None, preemptible=None,
               on_event=None, export_kv=False):
        """Enqueue one prompt (token ids) → :class:`GenerationHandle`
        (``generate.py:1425``). ``deadline`` is an absolute
        ``time.monotonic`` instant (``serving.parse_deadline``): expired
        in the queue, the request fails with
        :class:`DeadlineExceededError` (504 on the wire); expired in a
        slot, the slot is evicted with reason ``deadline``. ``rt`` is
        the request's ``tracing.RequestTrace``. ``qos_class`` defaults
        to the ledger's class of ``tenant`` (``"standard"`` without a
        ledger); ``preemptible`` defaults to every class but
        ``interactive``; ``on_event(event, attrs)`` hears ``suspended``
        and ``resumed``. ``export_kv`` makes it a prefill-only request
        whose pages come back as ``handle.kv_bundle`` (reason
        ``exported``): its ``max_tokens`` is the importing engine's
        budget, so only the prompt has to fit here. Raises
        :class:`DrainingError` once the engine drains."""
        try:
            tokens = [int(t) for t in tokens]
        except (TypeError, ValueError):
            raise ValueError("tokens must be a list of token ids") \
                from None
        if not tokens:
            raise ValueError("prompt must be a non-empty token list")
        vocab = self.config.vocab_size
        if any(t < 0 or t >= vocab for t in tokens):
            raise ValueError(f"token ids must be in [0, {vocab})")
        max_tokens = int(max_tokens if max_tokens is not None
                         else self.default_max_tokens)
        if max_tokens < 1:
            raise ValueError(f"max_tokens must be >= 1, got {max_tokens}")
        # an export never decodes here (generate.py:1454-1464)
        decoded = 0 if export_kv else max_tokens
        if len(tokens) + decoded > self.max_context:
            raise ValueError(
                f"prompt ({len(tokens)} tokens) + max_tokens "
                f"({max_tokens}) exceeds max_context "
                f"({self.max_context})")
        worst = self._worst_case_blocks(len(tokens), decoded)
        if worst > self.num_blocks:
            raise ValueError(
                f"request needs up to {worst} cache blocks but the "
                f"pool holds {self.num_blocks}; lower max_tokens or "
                f"grow num_blocks")
        handle = self._handle(tokens, max_tokens, eos_id, deadline,
                              on_token, on_done, rt, tenant, qos_class,
                              preemptible, on_event)
        handle.export_kv = bool(export_kv)
        return self._enqueue(handle)

    def _handle(self, prompt, max_tokens, eos_id, deadline, on_token,
                on_done, rt, tenant, qos_class, preemptible, on_event):
        """A new handle with its stop token and QoS class resolved:
        ``qos_class`` defaults to the ledger's class of ``tenant``;
        interactive never suspends by default, being the class that
        preemption protects."""
        eos = self.eos_id if eos_id is None else int(eos_id)
        if qos_class is None:
            qos_class = (self._qos.class_of(tenant)
                         if self._qos is not None
                         else qos_lib.DEFAULT_CLASS)
        if qos_class not in qos_lib.PRIORITY:
            raise ValueError(
                f"unknown qos class {qos_class!r} (expected one of "
                f"{qos_lib.QOS_CLASSES})")
        handle = GenerationHandle(prompt, max_tokens, eos, deadline,
                                  on_token, on_done, rt)
        handle.tenant = tenant
        handle.qos_class = qos_class
        handle.preemptible = (qos_class != "interactive"
                              if preemptible is None
                              else bool(preemptible))
        handle.on_event = on_event
        handle._engine = self
        return handle

    def _enqueue(self, handle):
        """Number ``handle`` and queue it; :class:`DrainingError` once the
        engine drains."""
        with self._cond:
            if self._draining or self._stop:
                raise DrainingError(
                    f"generation engine {self.name!r} is draining; "
                    f"retry against another replica")
            self._seq += 1
            handle.seq = self._seq
            self._queue.append(handle)
            self._book_queued_tokens_locked()
            self._cond.notify()
        return handle

    def _book_queued_tokens_locked(self):
        """Refresh ``serving_generate_queued_prompt_tokens`` (lock
        held): the prompt tokens waiting for admission, a suspended
        request's emitted tokens included (its resume prefills them)."""
        _QUEUED_PROMPT_TOKENS.labels(self.name).set(self._queued_tokens())

    def _queued_tokens(self):
        return sum(len(h.prompt) + len(h.out_tokens) for h in self._queue)

    def generate(self, tokens, **kwargs):
        """Blocking convenience → ``(generated_tokens, reason)``."""
        return self.submit(tokens, **kwargs).result()

    # ------------------------------------------- KV-page migration API

    def prefill_export(self, tokens, max_tokens=None, timeout=None,
                       **kwargs):
        """Prefill only (chunked or monolithic, prefix-cache hits
        honoured) and return the page bundle — ``submit(export_kv=True)``
        and wait (``generate.py:1519``). ``max_tokens`` is the decode
        budget the bundle carries to the importing engine."""
        handle = self.submit(tokens, max_tokens=max_tokens,
                             export_kv=True, **kwargs)
        if not handle.wait(timeout):
            self.cancel(handle, reason="abandoned")
            raise TimeoutError("prefill export did not finish in time")
        if handle.error is not None:
            raise handle.error
        if handle.kv_bundle is None:
            raise RuntimeError(
                f"prefill export finished with reason "
                f"{handle.reason!r} and no bundle")
        return handle.kv_bundle

    def import_bundle(self, bundle, *, max_tokens=None, eos_id=None,
                      deadline=None, on_token=None, on_done=None,
                      on_event=None, rt=None, tenant=None,
                      qos_class=None, preemptible=None):
        """Queue an exported page bundle for admission straight into
        decode → :class:`GenerationHandle` (``generate.py:1539-1665``).
        Its stream starts with the bundle's first token, then decodes
        over the imported pages. The pages may be torch tensors
        (``serving.decode_kv_bundle``) or numpy arrays (the JAX
        package's codec); they are compared with the pool by dtype name
        and copied in by the engine thread at admission. Every check of
        JAX's, in its order, raises :class:`KVImportError` booked by
        reason on ``serving_kv_import_rejections_total``; the budget
        defaults to the bundle's ``max_tokens``, the class and tenant as
        in :meth:`submit`."""
        meta = bundle["meta"]
        pages = tuple(bundle["pages"])
        c = self.config

        def reject(reason, msg):
            with self._cond:          # handler threads import concurrently
                self.stats["kv_import_rejections"] += 1
            _KV_IMPORT_REJECTIONS.labels(self.name, reason).inc()
            raise KVImportError(reason, msg)

        if self.role == "prefill":
            reject("role",
                   f"engine {self.name!r} has role='prefill': it "
                   f"exports bundles, it does not import them")
        if self.mesh is not None:
            reject("mesh",
                   "page import into a tensor-sharded pool is not "
                   "supported (the bundle is a single-chip layout); "
                   "route this prompt to an unsharded decode replica")
        if int(meta.get("block_size", -1)) != self.block_size:
            reject("block_size",
                   f"bundle block_size {meta.get('block_size')} != "
                   f"pool block_size {self.block_size}")
        if (int(meta.get("n_layers", -1)) != c.n_layers
                or int(meta.get("kv_heads", -1)) != c.kv_heads
                or int(meta.get("head_dim", -1)) != c.head_dim):
            reject("geometry",
                   f"bundle geometry (layers={meta.get('n_layers')}, "
                   f"kv_heads={meta.get('kv_heads')}, head_dim="
                   f"{meta.get('head_dim')}) does not match the pool "
                   f"({c.n_layers}, {c.kv_heads}, {c.head_dim})")
        pool = self._shards[0].cache        # one shard: no mesh here
        want = tuple(serving_lib.dtype_name(x) for x in pool)
        got = tuple(serving_lib.dtype_name(p) for p in pages)
        if got != want:
            reject("dtype",
                   f"bundle component dtypes {got} != pool {want} "
                   f"(pages must ship in the pool's native dtype)")
        try:
            prompt = [int(t) for t in meta["prompt"]]
            first = int(meta["first_token"])
            n_import = int(meta["n_blocks"])
        except (KeyError, TypeError, ValueError):
            reject("geometry", "bundle meta is missing prompt/"
                   "first_token/n_blocks")
        if not prompt or any(t < 0 or t >= c.vocab_size
                             for t in prompt) \
                or not 0 <= first < c.vocab_size:
            reject("vocab",
                   f"bundle tokens must be ids in [0, {c.vocab_size})")
        if n_import != -(-len(prompt) // self.block_size):
            reject("geometry",
                   f"bundle ships {n_import} blocks for a "
                   f"{len(prompt)}-token prompt at block_size "
                   f"{self.block_size}")
        for p, comp in zip(pages, pool):
            if tuple(p.shape) != (comp.shape[0], n_import) \
                    + tuple(comp.shape[2:]):
                reject("geometry",
                       f"bundle page shape {tuple(p.shape)} does not "
                       f"match pool block layout")
        max_tokens = int(max_tokens if max_tokens is not None
                         else meta.get("max_tokens")
                         or self.default_max_tokens)
        if max_tokens < 1:
            raise ValueError(
                f"max_tokens must be >= 1, got {max_tokens}")
        if len(prompt) + max_tokens > self.max_context:
            reject("capacity",
                   f"prompt ({len(prompt)}) + max_tokens "
                   f"({max_tokens}) exceeds max_context "
                   f"({self.max_context})")
        needed = max(n_import,
                     -(-(len(prompt) + max_tokens) // self.block_size))
        if needed > self.num_blocks:
            reject("capacity",
                   f"import needs up to {needed} cache blocks but "
                   f"the pool holds {self.num_blocks}")
        handle = self._handle(prompt, max_tokens, eos_id, deadline,
                              on_token, on_done, rt, tenant, qos_class,
                              preemptible, on_event)
        handle.kv_bundle = {
            "meta": meta,
            "pages": tuple(serving_lib.page_tensor(p) for p in pages),
            "_t_recv": bundle.get("_t_recv", time.perf_counter())}
        return self._enqueue(handle)

    def cancel(self, handle, reason="cancelled"):
        """Evict ``handle``'s slot (or dequeue it) before the next
        decode step; the transport cancels with reason ``disconnect``
        when the client goes away mid-stream."""
        with self._cond:
            handle.cancelled = True
            handle.cancel_reason = reason
            self._cond.notify()

    def begin_drain(self):
        """Active slots are evicted (reason ``draining``: an open stream
        gets a ``draining`` frame), queued prompts fail with
        :class:`DrainingError`, further submits refuse. The engine
        thread stays up until :meth:`close`."""
        with self._cond:
            self._draining = True
            self._cond.notify()

    def close(self, graceful=True):
        """Stop the engine: drain as :meth:`begin_drain`, then end the
        engine thread. ``graceful`` is accepted for symmetry with the
        JAX engine: both ways evict active slots with a termination
        frame (a half-generated sequence has no successor to go to)."""
        with self._cond:
            self._draining = True
            self._stop = True
            self._cond.notify()
        self.thread.join(timeout=10)

    def occupancy(self):
        with self._cond:
            return sum(1 for s in self._slots if s is not None)

    def measure_collective_share(self, iters=5):
        """Calibrate ``serving_generate_shard_collective_share``
        (``generate.py:1137``): time the real decode step against its
        twin with every gather/psum replaced by a local tile of the same
        shape (``_elide_collectives``), over an idle batch that writes
        and reads nothing, the minimum of ``iters`` each (a host hiccup
        only ever inflates a sample). Call while the engine is idle: it
        runs on the caller's thread. → the share (0.0 unsharded)."""
        if self.mesh is None:
            _SHARD_COLLECTIVE_SHARE.labels(self.name).set(0.0)
            return 0.0
        idle = self._put(self._blank_step(np.empty_like(self._step_np)))

        def sync():
            for d in self._devices:
                if d.type == "cuda":
                    torch.cuda.synchronize(d)

        def timed():
            with torch.no_grad():
                self._decode_step(idle)
                sync()
                best = float("inf")
                for _ in range(iters):
                    t0 = time.perf_counter()
                    self._decode_step(idle)
                    sync()
                    best = min(best, time.perf_counter() - t0)
            return best

        self._elide_collectives = True
        try:
            t_local = timed()
        finally:
            self._elide_collectives = False
        t_sharded = timed()
        share = max(0.0, 1.0 - t_local / t_sharded) if t_sharded else 0.0
        self.stats["collective_share"] = round(share, 4)
        _SHARD_COLLECTIVE_SHARE.labels(self.name).set(share)
        return share

    def collective_bytes_per_step(self):
        """Analytic ring-model cross-shard traffic of ONE decode step,
        per shard (``generate.py:1195``): an all-gather of N bytes
        delivers ``(tp-1)/tp × N`` to each shard, a psum ``2(tp-1)/tp ×
        N``. ``per_layer`` is the default layout's two raw-activation
        gathers (d_model + ff_dim wide) or the row layout's two
        d_model-wide psums; ``per_step`` the row layout's embed psum and
        fp32 vocab gather; ``total`` = ``n_layers × per_layer +
        per_step``. Zeros unsharded."""
        if self.mesh is None or self.tp == 1:
            return {"per_layer": 0, "per_step": 0, "total": 0}
        c = self.config
        rows = self.max_slots          # decode: one token per slot
        act = torch.empty((), dtype=c.compute_dtype).element_size()
        ring = (self.tp - 1) / self.tp
        if self.row_shard:
            per_layer = 2 * (2 * ring * rows * c.d_model * act)
            per_step = (2 * ring * rows * c.d_model * act
                        + ring * rows * c.vocab_size * 4)
        else:
            per_layer = ring * rows * (c.d_model + c.ff_dim) * act
            per_step = 0
        return {"per_layer": round(per_layer),
                "per_step": round(per_step),
                "total": round(c.n_layers * per_layer + per_step)}

    def mesh_view(self):
        """The sharding summary of the done frame and the snapshot
        (``generate.py:1228``): the mesh size and the per-shard block
        count. Every shard holds a slice of EVERY block, so one shard's
        exhaustion is the pool's."""
        return {"tensor": self.tp, "devices": self.tp,
                "cache_blocks": self.num_blocks,
                "per_chip_blocks": self.per_chip_blocks}

    def mesh_header(self):
        """``X-Generate-Mesh`` wire value, mirrored by the router."""
        return (f"tensor={self.tp};"
                f"per_chip_blocks={self.per_chip_blocks}")

    def attn_view(self):
        """The done frame's ``attn_backend``: the selected pool-read
        backend, unconditionally."""
        return self.attn_backend

    def spec_view(self, handle=None):
        """Speculative-decoding economics (``generate.py:1254``); None
        when speculation is off. With a ``handle``, adds the request's
        own view — ``accepted_per_step`` is the mean draft tokens kept
        per verify round (each round emits that + 1)."""
        if not self._spec_on:
            return None
        proposed = self.stats["spec_proposed"]
        accepted = self.stats["spec_accepted"]
        view = {"k": self.spec_k,
                "draft_layers": self.draft_config.n_layers,
                "proposed": proposed, "accepted": accepted,
                "acceptance_ratio": round(accepted / proposed, 4)
                if proposed else None}
        if handle is not None:
            view.update({
                "steps": handle.spec_rounds,
                "request_proposed": handle.spec_proposed,
                "request_accepted": handle.spec_accepted,
                "accepted_per_step": round(
                    handle.spec_accepted / handle.spec_rounds, 3)
                if handle.spec_rounds else 0.0})
        return view

    def spec_header(self):
        """``X-Spec-Acceptance`` wire value (``generate.py:1281``);
        None when speculation is off. The transport sends the copy
        frozen on the handle at its prefill (``spec_wire``)."""
        if not self._spec_on:
            return None
        return (f"k={self.spec_k};"
                f"proposed={self.stats['spec_proposed']};"
                f"accepted={self.stats['spec_accepted']}")

    def token_latency_view(self, handle):
        """The done frame's token latency: TTFT and the request's own
        inter-emission-gap median and max (None before the first token
        / the second emission event)."""
        gaps = list(handle.itg_gaps)
        return {
            "ttft_s": round(handle.ttft_s, 6)
            if handle.ttft_s is not None else None,
            "itg_p50_s": round(statistics.median(gaps), 6)
            if gaps else None,
            "itg_max_s": round(max(gaps), 6) if gaps else None,
        }

    def qos_view(self, handle):
        """The done frame's tenancy view; None for an anonymous request
        that was never preempted."""
        if handle.tenant is None and not handle.preemptions:
            return None
        return {
            "tenant": handle.tenant,
            "class": handle.qos_class,
            "preemptions": handle.preemptions,
            "resume_prefill_tokens": handle.resume_prefill_tokens,
        }

    def ttft_header(self, handle):
        """``X-TTFT-Ms``: the done frame's rounded ``ttft_s`` in ms, by
        the shortest round-trip ``repr`` (``generate.py:1384``), so the
        two agree exactly. None before the first token."""
        if handle.ttft_s is None:
            return None
        return repr(round(round(handle.ttft_s, 6) * 1000, 3))

    def timeline_view(self):
        """The slot-lifecycle ring, oldest first."""
        return list(self._timeline)

    def token_latency_stats(self):
        """Engine-wide TTFT / inter-token-gap percentiles from the raw
        sample rings (``generate.py:1397``): the sample at index
        ``int(q · n)`` of the sorted ring, in ms."""
        def pctl(vals, q):
            return vals[min(len(vals) - 1, int(q * len(vals)))]

        ttft = sorted(self._ttft_samples)
        itg = sorted(self._itg_samples)
        return {
            "ttft_count": len(ttft),
            "ttft_p50_ms": round(1000 * pctl(ttft, 0.50), 3)
            if ttft else None,
            "ttft_p95_ms": round(1000 * pctl(ttft, 0.95), 3)
            if ttft else None,
            "itg_count": len(itg),
            "itg_p50_ms": round(1000 * pctl(itg, 0.50), 3)
            if itg else None,
            "itg_p99_ms": round(1000 * pctl(itg, 0.99), 3)
            if itg else None,
            "itg_max_ms": round(1000 * max(itg), 3) if itg else None,
        }

    def snapshot(self):
        """Operator view for ``/v1/models/<name>``: every key of the
        JAX engine's (``generate.py:1702-1808``) plus the port's
        ``device`` and ``stats``. ``free_blocks`` counts what is
        allocatable now: the free list plus the cached zero-ref blocks
        the LRU reclaimer hands out on demand."""
        with self._cond:
            reclaimable = self._n_reclaimable
            hits = self.stats["prefix_hits"]
            misses = self.stats["prefix_misses"]
            now_w, now_pc = time.time(), time.perf_counter()
            now_mono = time.monotonic()
            slot_detail = []
            for i, s in enumerate(self._slots):
                if s is None:
                    slot_detail.append(None)
                    continue
                h = s.handle
                slot_detail.append({
                    "slot": i,
                    "request": h.seq,
                    "age_s": round(now_w - h.admitted_w, 3)
                    if h.admitted_w is not None else None,
                    "tokens_emitted": len(h.out_tokens),
                    "deadline_remaining_s":
                        round(h.deadline - now_mono, 3)
                        if h.deadline is not None else None,
                    "last_emit_age_s": round(now_pc - h.last_emit, 3)
                    if h.last_emit is not None else None,
                    "tenant": h.tenant,
                    "qos_class": h.qos_class,
                    "preemptible": h.preemptible,
                })
            return {
                "slots": self.max_slots,
                "occupied": sum(1 for s in self._slots if s is not None),
                "role": self.role,
                "queued_tokens": self._queued_tokens(),
                # page migration: the export side books bytes, the
                # import side latency and rejections
                "migration": {
                    "exports": self.stats["kv_exports"],
                    "imports": self.stats["kv_imports"],
                    "bytes": self.stats["kv_bytes_migrated"],
                    "rejections": self.stats["kv_import_rejections"],
                },
                "slot_detail": slot_detail,
                "timeline": self.timeline_view(),
                "queued": len(self._queue),
                "blocks": self.num_blocks,
                "free_blocks": len(self._free) + reclaimable,
                "block_size": self.block_size,
                "max_context": self.max_context,
                "kv_dtype": self.kv_dtype or str(
                    self.config.compute_dtype).replace("torch.", ""),
                "draining": self._draining,
                "attn_backend": self.attn_backend,
                "attn_bytes_read": self.stats["attn_bytes_read"],
                "device": str(self.device),
                "prefill_chunk": self.prefill_chunk or None,
                "prefill_chunks": self.stats["prefill_chunks"],
                "mesh": self.mesh_view(),
                "speculative": self.spec_view(),
                "prefix_cache": {
                    "enabled": self.prefix_cache,
                    "cached_blocks": len(self._node_by_block),
                    "reclaimable_blocks": reclaimable,
                    "pinned_blocks": len(self._node_by_block) - reclaimable,
                    "hits": hits,
                    "misses": misses,
                    "hit_ratio": round(hits / (hits + misses), 4)
                    if hits + misses else None,
                    "tokens_skipped": self.stats["prefix_tokens_skipped"],
                    "reclaims": self.stats["prefix_reclaims"],
                },
                "stats": dict(self.stats),
            }

    def blocks_view(self):
        """One consistent snapshot of the pool partition
        (``generate.py:1810``): every block is in exactly one of ``free``,
        ``cached`` (indexed, refcount 0) or ``referenced`` (refcount > 0),
        and ``refcounts[b]`` equals b's table/in-flight membership
        count (``table_refs``)."""
        with self._cond:
            table_refs = collections.Counter(self._inflight)
            for s in self._slots:
                if s is not None:
                    table_refs.update(s.blocks)
            return {
                "free": sorted(self._free),
                "cached": sorted(b for b in self._node_by_block
                                 if self._ref[b] == 0),
                "referenced": sorted(b for b in range(self.num_blocks)
                                     if self._ref[b] > 0),
                "refcounts": list(self._ref),
                "table_refs": dict(table_refs),
                "reclaimable_count": self._n_reclaimable,
            }

    # ---------------------------------------------------- engine loop

    def _loop(self):
        stats = self.stats
        with torch.no_grad():
            while True:
                with self._cond:
                    if self._idle_locked():
                        t0, t0w = time.perf_counter(), time.time()
                        while self._idle_locked():
                            self._cond.wait()
                        stats["idle_wait_seconds_total"] += \
                            time.perf_counter() - t0
                        self.trace.record("engine.wait", t0w, time.time())
                    stop, draining = self._stop, self._draining
                try:
                    if draining:
                        self._drain_now()
                        if stop:
                            return
                        with self._cond:
                            while not self._stop and not self._queue:
                                self._cond.wait()
                        continue
                    # JAX's order (generate.py:1859-1872): the sweeps
                    # bracket admission, so an expired deadline waits
                    # for at most one prefill chunk and one step
                    stats["iterations"] += 1
                    t0, t0w = time.perf_counter(), time.time()
                    calls = stats["prefill_seconds_total"] \
                        + stats["import_seconds_total"]
                    self._sweep_queued()
                    self._admit()
                    self._sweep_active()
                    self._advance_prefills()
                    stats["admit_seconds_total"] += (
                        time.perf_counter() - t0
                        - stats["prefill_seconds_total"]
                        - stats["import_seconds_total"] + calls)
                    self.trace.record("engine.admit", t0w, time.time())
                    if any(s is not None and not s.prefilling
                           for s in self._slots):
                        if self._spec_on:
                            self._spec_decode_once()
                        else:
                            self._decode_once()
                except Exception as e:  # noqa: BLE001 — no caller may hang
                    log.exception("generation engine %s loop iteration "
                                  "crashed; failing in-flight work",
                                  self.name)
                    self._fail_everything(e)

    def _idle_locked(self):
        """Nothing to do: no stop, no drain, no queue, every slot free
        (lock held)."""
        return (not self._stop and not self._draining and not self._queue
                and not any(s is not None for s in self._slots))

    def _drain_now(self):
        with self._cond:
            queued = list(self._queue)
            self._queue.clear()
            self._book_queued_tokens_locked()
        for handle in queued:
            self._finish(handle, "draining", DrainingError(
                f"generation engine {self.name!r} is draining; retry "
                f"against another replica"))
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._evict(i, "draining")

    def _fail_everything(self, error):
        with self._cond:
            queued = list(self._queue)
            self._queue.clear()
            self._book_queued_tokens_locked()
        for handle in queued:
            self._finish(handle, "error", error)
        for i, slot in enumerate(self._slots):
            if slot is not None:
                self._evict(i, "error", error)
        # the pool is updated in place (JAX rebuilds its donated buffers
        # here): a step that raised may have written part of its pages,
        # so the trie — which would advertise them — is dropped and the
        # bookkeeping reset wholesale (generate.py:1922-1932). Every slot
        # is evicted and the queue is empty, so nothing references a
        # page; the draft cache is scratch and needs no reset.
        with self._cond:
            self._free = list(range(self.num_blocks))
            self._ref = [0] * self.num_blocks
            self._root = _PrefixNode(None, None, None)
            self._node_by_block = {}
            self._inflight = []
            self._reclaimable = {}
            self._n_reclaimable = 0
        _PREFIX_CACHED_BLOCKS.labels(self.name).set(0)

    def _expired_in_queue(self, handle):
        """Book an expired queued request's wait (outcome ``expired``)
        → its :class:`DeadlineExceededError`."""
        waited = time.perf_counter() - handle.enqueued
        _QUEUE_WAIT_SECONDS.labels(self.name, "expired").observe(waited)
        return DeadlineExceededError(
            f"deadline expired while queued for a generation slot "
            f"(waited {waited * 1000:.0f} ms)")

    def _sweep_queued(self):
        """Fail queued requests that died waiting (cancel, deadline)
        before a prefill is spent on them (``generate.py:1935``)."""
        with self._cond:
            queued = list(self._queue)
        now = time.monotonic()
        for handle in queued:
            if handle.cancelled:
                reason, err = handle.cancel_reason, None
            elif handle.deadline is not None and now >= handle.deadline:
                reason, err = "deadline", self._expired_in_queue(handle)
            else:
                continue
            with self._cond:
                try:
                    self._queue.remove(handle)
                except ValueError:
                    continue      # admitted by a racing pass
                self._book_queued_tokens_locked()
            self._finish(handle, reason, err)

    def _sweep_active(self):
        """Evict slots that should not take another step: cancelled
        (disconnected) streams and expired deadlines
        (``generate.py:1965``)."""
        now = time.monotonic()
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            handle = slot.handle
            if handle.cancelled:
                self._evict(i, handle.cancel_reason)
            elif handle.deadline is not None and now >= handle.deadline:
                self._evict(i, "deadline")

    # ------------------------------------------------------- admission

    def _worst_case_blocks(self, prompt_len, max_tokens, matched_blocks=0):
        """Worst-case blocks a sequence owns or shares over its life —
        the padded (partial) prefill write, or every prompt and decode
        position, whichever is larger — minus the ``matched_blocks``
        already resident in the prefix cache (``generate.py:1980``).
        Under chunked prefill only the last chunk is bucket-padded."""
        offset = matched_blocks * self.block_size
        C = self.prefill_chunk
        if C and prompt_len - offset > C:
            k = (prompt_len - offset - 1) // C
            rem = prompt_len - offset - k * C
            cap = self.blocks_per_slot * self.block_size
            padded_suffix = k * C + min(serving_lib.bucket_for(rem), C,
                                        cap - offset - k * C)
        else:
            padded_suffix = self._suffix_padded(prompt_len, offset)
        total = max(offset + padded_suffix, prompt_len + max_tokens)
        return -(-total // self.block_size) - matched_blocks

    def _suffix_padded(self, prompt_len, offset):
        """Padded prefill length from ``offset``: the bucket, clamped
        so the padded tail never runs past the per-slot capacity."""
        cap = self.blocks_per_slot * self.block_size
        return min(serving_lib.bucket_for(prompt_len - offset),
                   cap - offset)

    def _match_prefix_locked(self, prompt):
        """Walk the trie over the full blocks of ``prompt`` → the
        matched node path (lock held). Capped one token short of the
        prompt, so at least one token always goes through prefill and
        the first generated token comes from a real forward."""
        nodes = []
        if not self.prefix_cache:
            return nodes
        bs = self.block_size
        node = self._root
        for j in range((len(prompt) - 1) // bs):
            child = node.children.get(tuple(prompt[j * bs:(j + 1) * bs]))
            if child is None:
                break
            nodes.append(child)
            node = child
        return nodes

    def _available_blocks(self):
        """Allocatable blocks (free list + cached zero-ref) minus the
        lazy allocations already promised to running slots."""
        reserved = sum(s.reserve - len(s.blocks)
                       for s in self._slots if s is not None)
        return len(self._free) + self._n_reclaimable - reserved

    def _alloc_block_locked(self):
        """One writable block, referenced (lock held): the free list,
        else the least recently used cached zero-ref leaf of the trie
        (leaf-first keeps every cached path rooted). The admission
        reservation guarantees this cannot fail for a running
        sequence."""
        if self._free:
            block = self._free.pop()
        else:
            if not self._reclaimable:
                raise RuntimeError("block pool exhausted despite admission "
                                   "reservation — accounting bug")
            victim = next(iter(self._reclaimable))     # LRU = oldest
            self._detach_node_locked(victim)
            self.stats["prefix_reclaims"] += 1
            _PREFIX_RECLAIMS_TOTAL.labels(self.name).inc()
            block = victim.block
        self._ref[block] += 1
        return block

    def _detach_node_locked(self, node):
        """Drop a zero-ref leaf from the trie (reclaim only); its parent
        may become a reclaim candidate itself."""
        self._reclaimable.pop(node, None)
        self._n_reclaimable -= 1
        parent = node.parent
        del parent.children[node.key]
        del self._node_by_block[node.block]
        if parent.block is not None and not parent.children \
                and self._ref[parent.block] == 0:
            self._reclaimable[parent] = None
        _PREFIX_CACHED_BLOCKS.labels(self.name).set(
            len(self._node_by_block))

    def _release_blocks_locked(self, blocks):
        """Drop one reference from each block: a zero-ref block stays
        cached if the trie indexes it, else returns to the free list."""
        now = time.monotonic()
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                node = self._node_by_block.get(b)
                if node is None:
                    self._free.append(b)
                else:
                    node.last_used = now
                    self._n_reclaimable += 1
                    if not node.children:
                        # re-append at the tail: the order stays LRU
                        self._reclaimable.pop(node, None)
                        self._reclaimable[node] = None

    def _pin_locked(self, matched):
        """Reference the matched prefix pages (lock held) → their ids."""
        now = time.monotonic()
        for node in matched:
            if self._ref[node.block] == 0:        # leaves the
                self._n_reclaimable -= 1          # reclaimable pool
                self._reclaimable.pop(node, None)
            self._ref[node.block] += 1
            node.last_used = now
        return [n.block for n in matched]

    def _index_prompt_locked(self, prompt, blocks, matched):
        """Index the prompt's full blocks (only those: a partial tail is
        written during decode and is never shared) under the matched
        path. An existing key means the match was capped at the
        prompt's last full block; the duplicate fresh page stays
        unindexed and frees on eviction."""
        bs = self.block_size
        node = matched[-1] if matched else self._root
        for j in range(len(matched), len(prompt) // bs):
            key = tuple(prompt[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _PrefixNode(key, blocks[j], node)
                node.children[key] = child
                self._node_by_block[blocks[j]] = child
            node = child
        _PREFIX_CACHED_BLOCKS.labels(self.name).set(
            len(self._node_by_block))

    def _book_match(self, handle, matched):
        offset = len(matched) * self.block_size
        handle.prefix_tokens_skipped = offset
        if not self.prefix_cache:
            return
        if matched:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_skipped"] += offset
            _PREFIX_HITS_TOTAL.labels(self.name).inc()
            _PREFIX_TOKENS_SKIPPED_TOTAL.labels(self.name).inc(offset)
        else:
            self.stats["prefix_misses"] += 1
            _PREFIX_MISSES_TOTAL.labels(self.name).inc()

    def _book_admission(self, handle, slot_idx, **attrs):
        """Admission bookkeeping shared by every prefill path: the
        queue wait (outcome ``admitted``), the request's queue phase and
        the ``admitted`` timeline event → (t0 perf_counter, t0 wall)."""
        t0, t0w = time.perf_counter(), time.time()
        handle.admitted_w = t0w
        wait_s = t0 - handle.enqueued
        _QUEUE_WAIT_SECONDS.labels(self.name, "admitted").observe(wait_s)
        self.stats["admissions"] += 1
        self.stats["queue_wait_seconds_total"] += wait_s
        if handle.rt is not None:
            handle.rt.phase("generate.queue_wait", handle.enqueued_w, t0w)
        self._record_event("admitted", handle, slot=slot_idx,
                           wait_s=round(wait_s, 6), **attrs)
        return t0, t0w

    def _book_prefill_call(self, handle, elapsed):
        """One prefill program call (a monolithic prefill or a chunk)."""
        self.stats["prefill_chunks"] += 1
        self.stats["prefill_seconds_total"] += elapsed
        _PREFILL_CHUNKS_TOTAL.labels(self.name).inc()
        _PREFILL_SECONDS.labels(self.name).observe(
            elapsed, trace_id=handle.rt.exemplar(elapsed)
            if handle.rt is not None else None)

    def _qos_priority(self, handle):
        return qos_lib.PRIORITY.get(handle.qos_class, 1)

    def _queue_candidate_locked(self):
        """The next admission candidate (lock held;
        ``generate.py:2122``). With ``preemption`` on: a cancelled entry
        first (cheap cleanup), else the highest class, submit order
        within a class — a suspended request keeps its ``seq``, so its
        resume outranks later arrivals of its class. A tenant whose
        bucket cannot pay its ``max_tokens`` now is passed over
        (deferred, not failed). ``preemption=False``: the head of the
        queue. None when every candidate is deferred."""
        if not self.preemption:
            return self._queue[0]
        best = best_key = None
        for h in self._queue:
            if h.cancelled:
                return h
            if self._qos is not None and h.tenant is not None \
                    and not h._qos_charged \
                    and not self._qos.fits(h.tenant, h.max_tokens):
                if not h._qos_deferred:
                    h._qos_deferred = True
                    self.stats["qos_deferrals"] += 1
                    qos_lib.THROTTLED_TOTAL.labels(h.tenant,
                                                   "deferred").inc()
                continue
            key = (-self._qos_priority(h), h.seq)
            if best is None or key < best_key:
                best, best_key = h, key
        return best

    def _preempt_victim_locked(self, priority):
        """The slot to suspend for a class-``priority`` admission (lock
        held; ``generate.py:2153``): preemptible, not cancelled, past
        its prefill (a mid-chunked-prefill slot has nothing to resume
        from), of a strictly lower class; the lowest class first, the
        youngest admission within it. None when nothing qualifies."""
        victim = victim_key = None
        for i, slot in enumerate(self._slots):
            if slot is None or slot.prefilling:
                continue
            h = slot.handle
            if not h.preemptible or h.cancelled:
                continue
            p = self._qos_priority(h)
            if p >= priority:
                continue
            key = (p, -(h.admitted_w or 0.0))
            if victim is None or key < victim_key:
                victim, victim_key = i, key
        return victim

    def _admit(self):
        """Move queued prompts into free slots while the pool can hold
        their worst case (``generate.py:2181-2290``), in the order of
        ``_queue_candidate_locked``; a candidate too big for the pool
        blocks the rest (no packing around it). The candidate's trie
        match is taken here, so the reservation charges only its
        unshared blocks; matched zero-ref pages leave the reclaimable
        pool when pinned, so they are debited. A resume re-admits the
        extended sequence (prompt + emitted tokens) with the remaining
        budget. When a slot or blocks are short under
        ``admission="continuous"`` with ``preemption`` on, a
        lower-class preemptible slot is suspended and admission tries
        again. The ledger is charged once, at the first admission.
        An import reserves its bundle's blocks plus the decode growth
        its budget promises, matches no prefix and goes to
        ``_import_admit``; an export reserves only its padded prefill.
        Under ``admission="drain"`` an occupied batch admits nothing;
        an empty one refills to capacity in one pass."""
        refilling = False
        while True:
            suspend = None
            with self._cond:
                if not self._queue:
                    return
                if self.admission == "drain" and not refilling \
                        and any(s is not None for s in self._slots):
                    return
                handle = self._queue_candidate_locked()
                if handle is None:
                    return       # every candidate budget-deferred
                free_slot, matched = None, []
                if not handle.cancelled:
                    free_slot = next((i for i, s in enumerate(self._slots)
                                      if s is None), None)
                    prompt = handle.prompt + handle.out_tokens \
                        if handle.suspended else handle.prompt
                    remaining = handle.max_tokens - len(handle.out_tokens)
                    if self._importing(handle):
                        # no prefill and no pinning: the bundle's blocks
                        # are written fresh (generate.py:2223-2233)
                        needed = max(
                            int(handle.kv_bundle["meta"]["n_blocks"]),
                            -(-(len(prompt) + remaining)
                              // self.block_size))
                        pinning = 0
                    else:
                        matched = self._match_prefix_locked(prompt)
                        needed = self._worst_case_blocks(
                            len(prompt),
                            0 if handle.export_kv else remaining,
                            len(matched))
                        pinning = sum(1 for n in matched
                                      if self._ref[n.block] == 0)
                    if free_slot is None \
                            or self._available_blocks() - pinning < needed:
                        if self.admission == "continuous" \
                                and self.preemption:
                            suspend = self._preempt_victim_locked(
                                self._qos_priority(handle))
                        if suspend is None:
                            return    # wait for evictions
                        suspend_why = "slot" if free_slot is None \
                            else "blocks"
                    else:
                        if self._qos is not None \
                                and handle.tenant is not None \
                                and not handle._qos_charged:
                            if not self._qos.try_charge(
                                    handle.tenant, handle.max_tokens):
                                return    # refill raced; next pass
                            handle._qos_charged = True
                        handle._qos_deferred = False
                if suspend is None:
                    self._queue.remove(handle)
                    self._book_queued_tokens_locked()
            if suspend is not None:
                self._suspend(suspend, suspend_why)
                continue
            refilling = True
            if handle.cancelled:
                self._finish(handle, handle.cancel_reason)
            elif handle.deadline is not None \
                    and time.monotonic() >= handle.deadline:
                self._finish(handle, "deadline",
                             self._expired_in_queue(handle))
            elif self._importing(handle):
                self._import_admit(free_slot, handle)
            else:
                self._prefill(free_slot, handle, matched)

    @staticmethod
    def _importing(handle):
        """Is ``handle`` a queued page import (not yet in the pool)?"""
        return handle.kv_bundle is not None and not handle.export_kv

    def _suspend(self, slot_idx, reason="slot"):
        """Pause ``slot_idx`` mid-stream without finishing it
        (``generate.py:2292``). Exactly the written K/V — prompt +
        emitted tokens up to ``slot.length``; the last emitted token is
        the next decode input and has none — is indexed into the trie
        before the pages release cache-retained, so the resume re-pins
        them and prefills only the unshared tail. The request re-queues
        with its original ``seq`` and a restarted queue-wait clock (its
        TTFT stays closed); the stream hears ``suspended`` with the
        tokens emitted so far, and its indices continue on resume."""
        slot = self._slots[slot_idx]
        handle = slot.handle
        with self._cond:
            self._slots[slot_idx] = None
            if self.prefix_cache:
                written = (handle.prompt + handle.out_tokens)[:slot.length]
                self._index_prompt_locked(
                    written, slot.blocks,
                    self._match_prefix_locked(written))
            self._release_blocks_locked(slot.blocks)
            handle.suspended = True
            handle.preemptions += 1
            handle.enqueued = time.perf_counter()
            handle.enqueued_w = time.time()
            self._queue.append(handle)
            self._book_queued_tokens_locked()
            self._cond.notify()
        self.stats["preemptions"] += 1
        _EVICTIONS_TOTAL.labels(self.name, "preempted").inc()
        _PREEMPTIONS_TOTAL.labels(self.name, reason).inc()
        if handle.tenant is not None:
            qos_lib.PREEMPTIONS_TOTAL.labels(handle.tenant,
                                             handle.qos_class).inc()
        self._record_event("suspended", handle, slot=slot_idx,
                           reason=reason, tokens=len(handle.out_tokens))
        if handle.rt is not None and slot.length > len(handle.prompt):
            handle.rt.phase("generate.decode", slot.decode_start_w,
                            tokens=len(handle.out_tokens))
        self._notify_event(handle, "suspended", reason="preempted",
                           tokens=len(handle.out_tokens))

    def _notify_event(self, handle, event, **attrs):
        """Fire the handle's lifecycle callback (``suspended`` /
        ``resumed``), which the transport relays as an event frame;
        guarded like ``_emit``."""
        if handle.on_event is None:
            return
        try:
            handle.on_event(event, dict(attrs))
        except Exception:  # noqa: BLE001 — a callback bug must not
            log.exception("on_event callback failed")  # kill the batch

    def _prefill(self, slot_idx, handle, matched=()):
        """Prefill ``handle`` into ``slot_idx``. With a trie match the
        matched pages are pinned into the table and only the unshared
        suffix runs, at positional offset ``len(matched)·block_size``,
        reading the prefix through the chunk read (``generate.py:2503``).
        A suffix longer than ``prefill_chunk`` goes the chunked way.

        A resume (``handle.suspended``) prefills the extended sequence,
        prompt + emitted tokens, with the remaining budget: the
        suspension indexed its written pages, so the match covers all
        but the last block or two. The last emitted token had no K/V
        (it was the next decode input), so it rides the prefill, whose
        last-row argmax is the next token of the uninterrupted
        stream."""
        resuming = handle.suspended
        prompt = handle.prompt + handle.out_tokens if resuming \
            else handle.prompt
        remaining = handle.max_tokens - len(handle.out_tokens)
        prompt_len = len(prompt)
        offset = len(matched) * self.block_size
        suffix_len = prompt_len - offset
        if self.prefill_chunk and suffix_len > self.prefill_chunk:
            # an export's reservation covers its prefill only
            self._begin_chunked_prefill(
                slot_idx, handle, matched, resuming, prompt,
                0 if handle.export_kv else remaining)
            return
        padded = self._suffix_padded(prompt_len, offset)
        n_blocks = -(-padded // self.block_size)
        with self._cond:
            prefix_blocks = self._pin_locked(matched)
            fresh = [self._alloc_block_locked() for _ in range(n_blocks)]
            self._inflight = prefix_blocks + fresh
        self._book_match(handle, matched)
        tokens = np.zeros((padded,), np.int64)
        tokens[:suffix_len] = prompt[offset:]
        t0, t0w = self._book_admission(handle, slot_idx)
        try:
            if matched:
                first = self._prefill_cached_step(
                    tokens, suffix_len, offset, prefix_blocks, fresh)
                dbg = None
            else:
                first, dbg = self._prefill_step(tokens, prompt_len, fresh)
            if self._spec_on and not handle.export_kv:
                self._draft_prefill_step(prompt, slot_idx)
        except Exception as e:  # noqa: BLE001 — fail THIS request: it is
            # in neither the queue nor a slot, so nothing else resolves
            # it; its pinned pages go back to the cache, its fresh pages
            # (possibly part-written, never indexed) to the free list
            with self._cond:
                self._release_blocks_locked(prefix_blocks + fresh)
                self._inflight = []
                self._cond.notify()
            log.exception("prefill failed for a %d-token prompt on "
                          "engine %s", prompt_len, self.name)
            self._finish(handle, "error", e)
            return
        elapsed = time.perf_counter() - t0
        self.trace.record("engine.prefill", t0w, time.time(),
                          {"prompt": prompt_len, "rows": padded})
        handle.prefill_seconds = elapsed
        if dbg is not None:
            handle.logits.append(dbg)
        self.stats["prefills"] += 1
        self._book_prefill_call(handle, elapsed)
        if handle.rt is not None:
            handle.rt.phase("generate.prefill", t0w, rows=padded,
                            prompt=prompt_len,
                            prefix_tokens_skipped=offset)
        self._record_event("prefill", handle, slot=slot_idx,
                           seconds=round(elapsed, 6))
        # frozen now: the stream head goes out after the first token,
        # which races this request's own verify rounds
        handle.spec_wire = self.spec_header()
        if matched:
            # the partial prefill read the shared prefix pages
            self._account_attn_read(self._blocks_touched(1, [offset]))
        if handle.export_kv:
            # prefill only (generate.py:2644-2658): the pages go to the
            # host, the prompt into the trie so the next cohort prompt
            # still hits, and the blocks release cache-retained — the
            # slot never decodes
            bundle = self._build_kv_bundle(handle, prompt,
                                           prefix_blocks + fresh, first,
                                           offset, elapsed)
            with self._cond:
                if self.prefix_cache:
                    self._index_prompt_locked(prompt, prefix_blocks + fresh,
                                              matched)
                self._release_blocks_locked(prefix_blocks + fresh)
                self._inflight = []
                self._cond.notify()
            self._book_export(handle, bundle, slot=slot_idx)
            return
        slot = _Slot(handle, prefix_blocks + fresh, prompt_len, first,
                     len(matched) + self._worst_case_blocks(
                         prompt_len, remaining, len(matched)))
        with self._cond:
            self._inflight = []
            self._slots[slot_idx] = slot
            if self.prefix_cache:
                self._index_prompt_locked(prompt, slot.blocks, matched)
        self._first_token(slot_idx, handle, first,
                          (offset, suffix_len) if resuming else None)

    def _first_token(self, slot_idx, handle, first, resumed=None):
        """Emit a prefill's token. The emission event is booked BEFORE
        the emit, so the transport reads TTFT when the first token
        arrives; a resume (``resumed`` = (prefix tokens skipped, tokens
        prefilled)) books a gap there instead — the suspension's wall
        time is the stream's price — and the ``resumed`` event."""
        self._note_emission_event(handle)
        if resumed is not None:
            offset, suffix_len = resumed
            handle.suspended = False
            handle.resume_prefill_tokens += suffix_len
            self.stats["resumes"] += 1
            self.stats["resume_prefill_tokens"] += suffix_len
            _RESUME_PREFILL_TOKENS.labels(self.name).inc(suffix_len)
            self._record_event("resumed", handle, slot=slot_idx,
                               prefix_tokens_skipped=offset,
                               prefilled=suffix_len)
            self._notify_event(handle, "resumed",
                               prefix_tokens_skipped=offset,
                               prefilled=suffix_len,
                               tokens=len(handle.out_tokens))
        else:
            self._record_event("first_token", handle, slot=slot_idx,
                               ttft_s=round(handle.ttft_s, 6))
        self._emit(handle, first)
        if handle.eos_id is not None and first == handle.eos_id:
            self._evict(slot_idx, "eos")
        elif len(handle.out_tokens) >= handle.max_tokens:
            self._evict(slot_idx, "length")

    # ------------------------------------------ KV-page export/import

    def _build_kv_bundle(self, handle, prompt, blocks, first, offset,
                         prefill_s):
        """The prompt's pages → the migration bundle (``generate.py:2358``):
        only the ``ceil(len / block_size)`` blocks that hold prompt K/V
        ship, in the pool's native dtype, copied to the host
        synchronously on the engine thread before the blocks release
        (a later prefill may overwrite them). The partial tail block
        ships with its pad rows, as a colocated slot holds it: every
        read is length-masked."""
        c = self.config
        n_keep = -(-len(prompt) // self.block_size)
        # a sharded pool ships as the single-chip layout: the shards'
        # heads joined in order (JAX's np.asarray, generate.py:2370-2372)
        pages = []
        for i in range(len(self._shards[0].cache)):
            parts = []
            for sh in self._shards:
                idx = torch.tensor(blocks[:n_keep], dtype=torch.long,
                                   device=sh.device)
                parts.append(sh.cache[i].index_select(1, idx).cpu())
            pages.append(parts[0] if len(parts) == 1
                         else torch.cat(parts, dim=3))
        pages = tuple(pages)
        # k + v pages apart from the int8 scales, for the wire-byte
        # accounting (int8 halves the page bytes; the scales ride on top)
        nbytes = [p.numel() * p.element_size() for p in pages]
        meta = {
            "model": self.name, "version": self.version,
            "prompt": list(prompt), "first_token": int(first),
            "max_tokens": int(handle.max_tokens),
            "eos_id": handle.eos_id,
            "block_size": self.block_size, "n_blocks": n_keep,
            "kv_dtype": self.kv_dtype
                or serving_lib.dtype_name(self._shards[0].cache[0]),
            "n_layers": c.n_layers, "kv_heads": c.kv_heads,
            "head_dim": c.head_dim,
            "prefix_tokens_skipped": int(offset),
            "prefill_seconds": prefill_s,
            "page_bytes": sum(nbytes[:2]), "scale_bytes": sum(nbytes[2:]),
        }
        return {"meta": meta, "pages": pages}

    def _book_export(self, handle, bundle, slot=None):
        """Finish an export: the bundle is the result (reason
        ``exported``); no token is emitted here — the first one rides
        the bundle and the importing engine's stream emits it
        (``generate.py:2394``)."""
        meta = bundle["meta"]
        nbytes = meta["page_bytes"] + meta["scale_bytes"]
        self.stats["kv_exports"] += 1
        self.stats["kv_bytes_migrated"] += nbytes
        _KV_MIGRATED_BYTES.labels(self.name, meta["kv_dtype"]).inc(nbytes)
        handle.kv_bundle = bundle
        self._record_event("exported", handle, slot=slot,
                           blocks=meta["n_blocks"], bytes=nbytes)
        self._finish(handle, "exported")

    def _import_admit(self, slot_idx, handle):
        """Admit an imported bundle (``generate.py:2410-2500``): allocate
        blocks, copy the pages into the pool (native dtype, no
        requantization; on this, the engine thread, which owns the
        pool), prefill the draft from the prompt when speculation is
        on, and install the slot straight into decode — ``length`` the
        prompt's, ``last_token`` the bundle's first token — with its
        prompt seeded into the trie. No forward pass runs; the stream
        starts with that first token. A failed copy frees the blocks
        and finishes the request with ``error``."""
        bundle = handle.kv_bundle
        meta, pages = bundle["meta"], bundle["pages"]
        prompt = handle.prompt
        prompt_len = len(prompt)
        n_import = int(meta["n_blocks"])
        with self._cond:
            blocks = [self._alloc_block_locked() for _ in range(n_import)]
            self._inflight = list(blocks)
        t0, t0w = self._book_admission(handle, slot_idx, imported=True)
        try:
            idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
            # import_bundle refuses every mesh: the pool is one shard's
            for pool, page in zip(self._shards[0].cache, pages):
                pool.index_copy_(1, idx, page.to(self.device))
            if self._spec_on:
                # the draft has no pages to import (a dense per-slot
                # cache of another model): it prefills from the prompt
                # so its proposals start aligned
                self._draft_prefill_step(prompt, slot_idx)
        except Exception as e:  # noqa: BLE001 — fail THIS request, or
            # the pool shrinks with every bad bundle
            with self._cond:
                self._release_blocks_locked(blocks)
                self._inflight = []
                self._cond.notify()
            log.exception("page import failed for a %d-block bundle on "
                          "engine %s", n_import, self.name)
            self._finish(handle, "error", e)
            return
        self.stats["import_seconds_total"] += time.perf_counter() - t0
        self.trace.record("engine.import", t0w, time.time(),
                          {"blocks": n_import})
        first = int(meta["first_token"])
        handle.prefix_tokens_skipped = int(
            meta.get("prefix_tokens_skipped") or 0)
        handle.prefill_seconds = float(meta.get("prefill_seconds") or 0.0)
        handle.kv_bundle = None    # the pages are in the pool now
        handle.spec_wire = self.spec_header()
        slot = _Slot(handle, blocks, prompt_len, first,
                     max(n_import, -(-(prompt_len + handle.max_tokens)
                                     // self.block_size)))
        with self._cond:
            self._inflight = []
            self._slots[slot_idx] = slot
            if self.prefix_cache:
                self._index_prompt_locked(prompt, slot.blocks,
                                          self._match_prefix_locked(prompt))
        elapsed = time.perf_counter() - bundle.get("_t_recv",
                                                   handle.enqueued)
        self.stats["kv_imports"] += 1
        _KV_MIGRATION_SECONDS.labels(self.name).observe(elapsed)
        self._record_event("imported", handle, slot=slot_idx,
                           blocks=n_import, seconds=round(elapsed, 6))
        self._first_token(slot_idx, handle, first)

    # ------------------------------------------------- chunked prefill

    def _begin_chunked_prefill(self, slot_idx, handle, matched, resuming,
                               prompt, remaining):
        """Admission half of a chunked prefill (``generate.py:2699``):
        pin the match and install the slot with ``prefilling=True``. Its
        table starts as the pinned prefix and grows one chunk of fresh
        blocks per ``_advance_prefills``; the whole reservation is
        debited here, so no later chunk can fail to allocate. A resume
        prefills ``prompt`` (the extended sequence) with ``remaining``
        tokens of budget."""
        offset = len(matched) * self.block_size
        with self._cond:
            prefix_blocks = self._pin_locked(matched)
        self._book_match(handle, matched)
        slot = _Slot(handle, prefix_blocks, offset, None,
                     len(matched) + self._worst_case_blocks(
                         len(prompt), remaining, len(matched)))
        slot.prefilling = True
        slot.pf_written = offset
        slot.pf_matched = list(matched)
        slot.pf_resuming = resuming
        slot.pf_t0, slot.pf_t0w = self._book_admission(
            handle, slot_idx, chunked_prefill=True)
        with self._cond:
            self._slots[slot_idx] = slot
            self._cond.notify()

    def _advance_prefills(self):
        """Advance at most one prefilling slot by one chunk
        (``generate.py:2759``). Every chunk reads the slot's own table
        through the chunk read: full chunks run at exactly
        ``prefill_chunk`` tokens, the last one is bucket-padded and
        gives the first token, at which point the slot decodes."""
        idx = next((i for i, s in enumerate(self._slots)
                    if s is not None and s.prefilling), None)
        if idx is None:
            return
        slot = self._slots[idx]
        handle = slot.handle
        prompt = handle.prompt + handle.out_tokens if slot.pf_resuming \
            else handle.prompt
        prompt_len = len(prompt)
        C = self.prefill_chunk
        written = slot.pf_written
        rem = prompt_len - written
        cap = self.blocks_per_slot * self.block_size
        is_final = rem <= C
        chunk_len = rem if is_final else C
        padded = min(serving_lib.bucket_for(rem), C,
                     cap - written) if is_final else C
        n_blocks = -(-padded // self.block_size)
        prefix_blocks = list(slot.blocks)
        with self._cond:
            # guaranteed by the admission-time reservation
            fresh = [self._alloc_block_locked() for _ in range(n_blocks)]
            slot.blocks.extend(fresh)
        tokens = np.zeros((padded,), np.int64)
        tokens[:chunk_len] = prompt[written:written + chunk_len]
        t0, t0w = time.perf_counter(), time.time()
        try:
            first = self._prefill_cached_step(tokens, chunk_len, written,
                                              prefix_blocks, fresh)
            if is_final and self._spec_on and not handle.export_kv:
                self._draft_prefill_step(prompt, idx)
        except Exception as e:  # noqa: BLE001 — the slot is installed:
            # evicting it releases every block it holds and finishes it
            log.exception("chunked prefill failed at offset %d of a "
                          "%d-token prompt on engine %s", written,
                          prompt_len, self.name)
            self._evict(idx, "error", e)
            return
        elapsed = time.perf_counter() - t0
        self.trace.record("engine.prefill", t0w, time.time(),
                          {"prompt": prompt_len, "rows": padded})
        slot.pf_chunks += 1
        self._book_prefill_call(handle, elapsed)
        if handle.rt is not None:
            handle.rt.phase("generate.prefill", t0w, rows=padded,
                            prompt=prompt_len, chunk=slot.pf_chunks,
                            offset=written)
        if written:
            # this chunk's attention read the whole written prefix
            self._account_attn_read(self._blocks_touched(1, [written]))
        slot.pf_written = written + chunk_len
        slot.length = slot.pf_written
        if not is_final:
            return
        slot.prefilling = False
        slot.last_token = first
        slot.decode_start_w = time.time()
        handle.prefill_seconds = time.perf_counter() - slot.pf_t0
        self._record_event("prefill", handle, slot=idx,
                           seconds=round(handle.prefill_seconds, 6),
                           chunks=slot.pf_chunks)
        self.stats["prefills"] += 1
        handle.spec_wire = self.spec_header()
        offset = len(slot.pf_matched) * self.block_size
        if handle.export_kv:
            # chunked prefill only (generate.py:2855-2870): the export of
            # _prefill, and the slot frees without the decode it will
            # never run (eviction reason "exported")
            bundle = self._build_kv_bundle(handle, prompt, slot.blocks,
                                           first, offset,
                                           handle.prefill_seconds)
            with self._cond:
                self._slots[idx] = None
                if self.prefix_cache:
                    self._index_prompt_locked(prompt, slot.blocks,
                                              slot.pf_matched)
                self._release_blocks_locked(slot.blocks)
                self._cond.notify()
            _EVICTIONS_TOTAL.labels(self.name, "exported").inc()
            self._book_export(handle, bundle, slot=idx)
            return
        with self._cond:
            # the prompt's blocks enter the trie only now, at its last
            # chunk (generate.py:2883-2886)
            if self.prefix_cache:
                self._index_prompt_locked(prompt, slot.blocks,
                                          slot.pf_matched)
        self._first_token(idx, handle, first,
                          (offset, prompt_len - offset)
                          if slot.pf_resuming else None)

    # ------------------------------------------------------ decode step

    def _decode_once(self):
        """One plain decode step, booked in four parts (the module
        docstring): prepare → launch → sync → emit. The test knob
        ``_step_sleep`` stands for device time, so it falls in sync."""
        tp, tpw = time.perf_counter(), time.time()
        # prefilling slots hold a slot and blocks but have no decode
        # state yet: they ride as inactive rows (generate.py:2913-2916)
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None and not s.prefilling]
        S, bs = self.max_slots, self.block_size
        tables, lengths, tokens, phys, off, live = self._step_views(
            self._blank_step(self._step_np))
        for i, slot in active:
            pos = slot.length
            block_idx = pos // bs
            if block_idx >= len(slot.blocks):
                # lazy page allocation, guaranteed by the reservation
                # (it may LRU-reclaim a cached zero-ref page)
                with self._cond:
                    slot.blocks.append(self._alloc_block_locked())
            tables[i, :len(slot.blocks)] = slot.blocks
            lengths[i] = pos
            tokens[i] = slot.last_token
            phys[i], off[i], live[i] = slot.blocks[block_idx], pos % bs, 1
        t0, t0w = time.perf_counter(), time.time()
        nxt, logits = self._decode_launch()
        # the step is queued: what follows waits for the device
        tl, tlw = time.perf_counter(), time.time()
        self._next_in.copy_(nxt)
        nxt = self._next_np
        if self._moe:
            self._book_moe(*self._step_tally, nxt[S], decode=True)
        dbg = logits.cpu().numpy() if self.debug_logits else None
        if self._step_sleep:
            time.sleep(self._step_sleep)
        t1, t1w = time.perf_counter(), time.time()
        elapsed = t1 - t0
        stats = self.stats
        stats["decode_prepare_seconds_total"] += t0 - tp
        stats["decode_launch_seconds_total"] += tl - t0
        stats["decode_sync_seconds_total"] += t1 - tl
        self.trace.record("engine.decode.prepare", tpw, t0w)
        self.trace.record("engine.decode.launch", t0w, tlw)
        self.trace.record("engine.decode.sync", tlw, t1w)
        _DECODE_STEP_SECONDS.labels(self.name).observe(elapsed)
        _SLOT_OCCUPANCY.labels(self.name).observe(len(active))
        self.stats["decode_steps"] += 1
        self.stats["decode_token_slots"] += len(active)
        self.stats["decode_seconds_total"] += elapsed
        self._account_attn_read(self._blocks_touched(
            S, [s.length + 1 for _, s in active]))
        self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"],
                                           len(active))
        for i, slot in active:
            slot.length += 1
            token = int(nxt[i])
            slot.last_token = token
            handle = slot.handle
            _TOKENS_PER_STEP.labels(self.name).observe(1)
            if dbg is not None:
                handle.logits.append(dbg[i])
            self._note_emission_event(handle)
            self._emit(handle, token)
            if handle.eos_id is not None and token == handle.eos_id:
                self._evict(i, "eos")
            elif len(handle.out_tokens) >= handle.max_tokens:
                self._evict(i, "length")
        stats["decode_emit_seconds_total"] += time.perf_counter() - t1
        self.trace.record("engine.decode.emit", t1w, time.time(),
                          {"rows": len(active)})

    # ------------------------------------------------ speculative step

    def _spec_decode_once(self):
        """One speculative round (``generate.py:2983``): the draft
        proposes up to ``spec_k`` tokens per decoding slot, one target
        forward scores all ``k + 1`` positions of every slot against the
        pool, and each slot emits its longest draft == target-argmax
        prefix plus the target's next token, then rolls its block table
        back to the first rejection. Every emitted token is the target's
        own argmax given the verified prefix, so the output is the plain
        engine's for any draft."""
        active = [(i, s) for i, s in enumerate(self._slots)
                  if s is not None and not s.prefilling]
        S, bps, bs = self.max_slots, self.blocks_per_slot, \
            self.block_size
        k = self.spec_k
        k_eff = {}
        last_token_round = True     # every slot on its last token
        with self._cond:
            free_budget = len(self._free)
        for i, slot in active:
            L = slot.length
            # clamp the depth so the verify writes (and the emitted
            # tokens) never run past max_tokens or the slot's
            # reservation: positions L..L+ke are written
            remaining = slot.handle.max_tokens - len(slot.handle.out_tokens)
            last_token_round &= remaining == 1
            ke = max(0, min(k, remaining - 1, self.max_context - 1 - L))
            # ...and so speculative allocation never reclaims a cached
            # prefix page for proposals that may be rejected: blocks
            # past the guaranteed next write come from the slot's own
            # table or the free list, drawn down slot by slot
            held = len(slot.blocks)
            base_need = L // bs + 1
            free_budget -= max(0, base_need - held)
            avail = max(held, base_need) + max(0, free_budget)
            ke = max(0, min(ke, avail * bs - 1 - L))
            free_budget -= max(0, (L + ke) // bs + 1
                               - max(held, base_need))
            k_eff[i] = ke
        if active and last_token_round:
            # every slot emits its final token and leaves this round:
            # the plain step does that without the draft; it still
            # counts as a round with no proposals
            self.stats["spec_rounds"] += 1
            for _, slot in active:
                slot.handle.spec_rounds += 1
            self._decode_once()
            return
        tables = np.zeros((S, bps), np.int32)
        lengths = np.zeros((S,), np.int32)
        tokens = np.zeros((S,), np.int64)
        # the last position each row may write; -1 for inactive rows.
        # JAX sends the rest to out-of-bounds sentinels that its
        # scatters drop (mode="drop"); here they are filtered out
        limits = np.full((S,), -1, np.int64)
        writes = []                              # (row, j, block, off)
        for i, slot in active:
            L = slot.length
            ke = k_eff[i]
            need = (L + ke) // bs + 1
            with self._cond:
                while len(slot.blocks) < need:
                    slot.blocks.append(self._alloc_block_locked())
            tables[i, :len(slot.blocks)] = slot.blocks
            lengths[i] = L
            tokens[i] = slot.last_token
            limits[i] = L + ke
            for j in range(ke + 1):
                p = L + j
                writes.append((i, j, slot.blocks[p // bs], p % bs))
        writes = np.asarray(writes, np.int64).T.reshape(4, -1)
        t0 = time.perf_counter()
        props = self._propose_step(tokens, lengths, limits)     # [S, k]
        vtokens = np.concatenate([tokens[:, None], props], axis=1)
        target = self._verify_step(tables, lengths, vtokens, writes)
        if self._step_sleep:
            time.sleep(self._step_sleep)
        elapsed = time.perf_counter() - t0
        _DECODE_STEP_SECONDS.labels(self.name).observe(elapsed)
        _SLOT_OCCUPANCY.labels(self.name).observe(len(active))
        self.stats["decode_steps"] += 1
        self.stats["decode_token_slots"] += len(active)
        self.stats["decode_seconds_total"] += elapsed
        # the verify read every active slot's cached prefix (depth L)
        self._account_attn_read(self._blocks_touched(
            S, [s.length for _, s in active]))
        self.stats["spec_rounds"] += 1
        self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"],
                                           len(active))
        accepts = {}
        for i, slot in active:
            ke = k_eff[i]
            a = 0
            while a < ke and props[i, a] == target[i, a]:
                a += 1
            accepts[i] = a
            handle = slot.handle
            handle.spec_rounds += 1
            handle.spec_proposed += ke
            handle.spec_accepted += a
            # booked before the emissions: an eviction below resolves
            # the handle, and its reader must see this round counted
            self.stats["spec_proposed"] += ke
            self.stats["spec_accepted"] += a
            if ke:
                _SPEC_PROPOSED_TOTAL.labels(self.name).inc(ke)
            if a:
                _SPEC_ACCEPTED_TOTAL.labels(self.name).inc(a)
        if self.stats["spec_proposed"]:
            _SPEC_ACCEPTANCE_RATIO.labels(self.name).set(
                self.stats["spec_accepted"] / self.stats["spec_proposed"])
        for i, slot in active:
            a = accepts[i]
            handle = slot.handle
            self._record_event("spec_round", handle, slot=i,
                               proposed=k_eff[i], accepted=a)
            L = slot.length
            # rollback: positions L..L+a stay, everything past the first
            # rejection is dead — truncate the table to the last valid
            # position and return the over-allocated fresh pages
            slot.length = L + a + 1
            slot.last_token = int(target[i, a])
            keep = (slot.length - 1) // bs + 1
            if len(slot.blocks) > keep:
                with self._cond:
                    extra = slot.blocks[keep:]
                    del slot.blocks[keep:]
                    self._release_blocks_locked(extra)
            # the verified burst is ONE emission event: one gap sample
            # per round, booked before any of its tokens
            self._note_emission_event(handle)
            emitted = 0
            for j in range(a + 1):
                token = int(target[i, j])
                self._emit(handle, token)
                emitted += 1
                if handle.eos_id is not None and token == handle.eos_id:
                    # nothing past the eos reaches the stream or the
                    # retained cache (eviction frees decode pages)
                    self._evict(i, "eos")
                    break
                if len(handle.out_tokens) >= handle.max_tokens:
                    self._evict(i, "length")
                    break
            _TOKENS_PER_STEP.labels(self.name).observe(emitted)

    def _record_event(self, event, handle, slot=None, **attrs):
        """One slot-lifecycle event: appended to the bounded ring
        (snapshot ``timeline``) and dropped as a zero-duration marker
        on the request's trace (``generate.slot<i>.<event>``).
        Engine-thread-only."""
        now = time.time()
        entry = {"ts": round(now, 6), "event": event,
                 "request": handle.seq}
        if slot is not None:
            entry["slot"] = slot
        entry.update(attrs)
        self._timeline.append(entry)
        if handle.rt is not None:
            lane = f"generate.slot{slot}" if slot is not None \
                else "generate.queue"
            handle.rt.phase(f"{lane}.{event}", now, end=now, **attrs)

    def _note_emission_event(self, handle):
        """Book ONE emission event before its tokens go out
        (``generate.py:1319``): the first closes the TTFT clock (submit
        → first token), every later one books an inter-token gap."""
        now = time.perf_counter()
        if handle.last_emit is None:
            handle.ttft_s = now - handle.enqueued
            self._ttft_samples.append(handle.ttft_s)
            _TTFT_SECONDS.labels(self.name).observe(
                handle.ttft_s, trace_id=handle.rt.exemplar(
                    handle.ttft_s) if handle.rt is not None else None)
            if handle.tenant is not None:
                qos_lib.TTFT_SECONDS.labels(
                    handle.tenant, handle.qos_class).observe(handle.ttft_s)
        else:
            gap = now - handle.last_emit
            handle.itg_gaps.append(gap)
            self._itg_samples.append(gap)
            _INTER_TOKEN_SECONDS.labels(self.name).observe(
                gap, trace_id=handle.rt.exemplar(gap)
                if handle.rt is not None else None)
            if handle.tenant is not None:
                qos_lib.INTER_TOKEN_SECONDS.labels(
                    handle.tenant, handle.qos_class).observe(gap)
        handle.last_emit = now

    def _emit(self, handle, token):
        handle.out_tokens.append(token)
        handle.token_times.append(time.time())
        _TOKENS_TOTAL.labels(self.name).inc()
        self.stats["tokens"] += 1
        if handle.tenant is not None:
            qos_lib.TOKENS_TOTAL.labels(handle.tenant,
                                        handle.qos_class).inc()
        if handle.on_token is not None:
            try:
                handle.on_token(token, len(handle.out_tokens) - 1)
            except Exception:  # noqa: BLE001 — a callback bug must not
                log.exception("on_token callback failed")  # kill the batch

    def _evict(self, slot_idx, reason, error=None):
        slot = self._slots[slot_idx]
        with self._cond:
            self._slots[slot_idx] = None
            # cache-retain eviction: indexed pages stay cached at
            # refcount 0, everything else frees (generate.py:3191-3198)
            self._release_blocks_locked(slot.blocks)
            self._cond.notify()
        _EVICTIONS_TOTAL.labels(self.name, reason).inc()
        handle = slot.handle
        self._record_event("evicted", handle, slot=slot_idx,
                           reason=reason, tokens=len(handle.out_tokens))
        if handle.rt is not None and slot.length > len(handle.prompt):
            handle.rt.phase("generate.decode", slot.decode_start_w,
                            tokens=len(handle.out_tokens))
        if reason == "deadline" and error is None:
            error = DeadlineExceededError(
                "deadline expired mid-generation; slot evicted")
        self._finish(handle, reason, error)

    def _finish(self, handle, reason, error=None):
        handle.reason = reason
        handle.error = error
        # a queue-side failure books 0 emitted tokens
        _EMITTED_TOKENS.labels(self.name).observe(len(handle.out_tokens))
        if handle.on_done is not None:
            try:
                handle.on_done(reason, list(handle.out_tokens), error)
            except Exception:  # noqa: BLE001 — see _emit
                log.exception("on_done callback failed")
        handle._done.set()

    def _account_attn_read(self, blocks_read):
        """Book the analytic bytes one step's attention read touched
        (blocks × per-block k/v bytes × layers), derived host-side from
        occupancy."""
        self.stats["attn_bytes_read"] += (int(blocks_read)
                                          * self._block_read_bytes)

    def _blocks_touched(self, n_rows, lengths_list):
        """Blocks one decode step's read touches: the gather read
        materializes the full pool width for every row; the paged read
        only the active rows' occupied blocks."""
        if self.attn_backend == "gather":
            return n_rows * self.blocks_per_slot
        return sum(-(-int(n) // self.block_size) for n in lengths_list)

    # --------------------------------------------------- device steps

    def _on_devices(self, fn):
        """``fn(device)`` once per distinct device of the shards →
        ``{device: result}``: a step's host inputs and replicated
        activations live once on every device."""
        return {d: fn(d) for d in self._devices}

    def _put(self, a):
        """A host numpy array → ``{device: tensor}``."""
        t = torch.from_numpy(a)
        return self._on_devices(lambda d: t.to(d))

    def _gathered(self, pieces, dev):
        """All-gather the shards' head/hidden slices along the last dim
        onto ``dev`` (``generate.py:1071``): each shard's activation goes
        to ``dev`` and the pieces join in shard order — a concatenation,
        no arithmetic, so the row projections that follow compute on the
        unsharded engine's values. One piece is returned as it is (the
        1-shard mesh is the unsharded engine). ``torch.cat`` copies, so
        no later in-place pool write reaches the result; a copy between
        cards runs ordered after both devices' current streams. Under
        ``_elide_collectives`` (the calibration twin) ``dev``'s own piece
        is tiled to the same shape instead."""
        if len(pieces) == 1:
            return pieces[0].to(dev)
        if self._elide_collectives:
            local = pieces[self._shards.index(self._lead[dev])]
            return torch.cat([local] * len(pieces), dim=-1)
        return torch.cat([p.to(dev) for p in pieces], dim=-1)

    def _psummed(self, partials, dev):
        """Sum the shards' partial products onto ``dev`` in shard order
        (``generate.py:1102``), the ``row_shard`` twin of
        ``_gathered``: each partial rounded before the sum, so this path
        is graded on the tolerance tier. ``dev``'s own partial alone
        under ``_elide_collectives``."""
        if self._elide_collectives:
            return partials[self._shards.index(self._lead[dev])]
        out = partials[0].to(dev)
        for p in partials[1:]:
            out = out + p.to(dev)
        return out

    def _embed(self, toks):
        """Token ids ``{device: ids}`` → the residual stream ``{device:
        x}`` (``generate.py:1116``). Under ``row_shard`` each shard owns
        a slice of the vocab rows: it looks up the ids it owns, zero
        elsewhere, and the partials are psummed — one non-zero
        contributor per row, so the sum is exact."""
        if not self.row_shard:
            return {d: transformer.embed(self._lead[d].params["embed"], t,
                                         self.config)
                    for d, t in toks.items()}
        vs = self.config.vocab_size // self.tp
        parts = []
        for i, sh in enumerate(self._shards):
            idx = toks[sh.device] - i * vs
            ok = (idx >= 0) & (idx < vs)
            rows = sh.params["embed"][idx.clamp(0, vs - 1)]
            parts.append(rows.masked_fill(~ok[..., None], 0))
        return self._on_devices(lambda d: self._psummed(parts, d))

    def _row_proj(self, xs, pieces, layer, name):
        """``x + pieces @ W`` for the row projection ``name`` (``wo`` or
        ``w_down``): by default the pieces gathered to full width on
        every device and multiplied by the replicated weight; under
        ``row_shard`` each shard's piece times its own rows of W, the
        partial products psummed."""
        if self.row_shard:
            partials = [torch.matmul(p, sh.layers[layer][name])
                        for p, sh in zip(pieces, self._shards)]
            return {d: x + self._psummed(partials, d)
                    for d, x in xs.items()}
        return {d: x + torch.matmul(self._gathered(pieces, d),
                                    self._lead[d].layers[layer][name])
                for d, x in xs.items()}

    def _head_logits(self, xs):
        """Final-norm hidden ``{device: x}`` → fp32 logits on the first
        device (``generate.py:3280``, ``transformer._logits``). The head
        is replicated by default, so the logits are computed once; under
        ``row_shard`` each shard computes its vocab slice and the slices
        are gathered (a concatenation of single-chip products)."""
        eps = self.config.norm_eps
        if self.row_shard:
            normed = {d: transformer._rmsnorm(
                x, self._lead[d].params["final_norm"], eps)
                for d, x in xs.items()}
            return self._gathered(
                [transformer._logits(normed[sh.device], sh.head)
                 for sh in self._shards], self.device)
        sh = self._shards[0]
        x = transformer._rmsnorm(xs[sh.device], sh.params["final_norm"], eps)
        return transformer._logits(x, sh.head)

    def _layer(self, xs, layer, attend, tally=None):
        """Layer ``layer`` over the residual stream ``{device: x}``
        through ``attend(i, q, k, v) → o`` (shard ``i``'s read):
        ``transformer.layer_core``'s unsharded form on one shard, each
        expert call's ``MoeTally`` appended to ``tally``; its sharded
        form over the mesh's hooks on several."""
        c = self.config
        if len(self._shards) > 1:
            return transformer.layer_core(
                xs, None, transformer.each_shard(attend), c,
                self._mesh_layers[layer])[0]
        (d, x), = xs.items()
        x, _, _ = transformer.layer_core(
            x, self._shards[0].layers[layer],
            lambda q, k, v: (attend(0, q, k, v), None), c, tally=tally)
        return {d: x}

    def _tallied(self, tally, value):
        """``value`` (a device tensor of int64 tokens, 0-d or ``[n]``)
        with the expert calls' active-expert tally after it, as one
        ``[n + 1]`` tensor, and the calls' host counts → ``(tensor,
        calls, rows, padded rows)``; ``value`` itself without experts."""
        if tally is None:
            return value, 0, 0, 0
        active = torch.stack([t.active for t in tally]).sum().to(
            torch.int64)
        return (torch.cat([value.reshape(-1), active[None]]), len(tally),
                sum(t.rows for t in tally), sum(t.padded for t in tally))

    def _book_moe(self, calls, rows, padded, active, decode=False):
        st = self.stats
        active = int(active)
        st["moe_calls"] += calls
        st["moe_assignments_total"] += rows
        st["moe_padded_rows_total"] += padded
        st["moe_active_experts_total"] += active
        if decode:
            st["moe_decode_calls"] += calls
            st["moe_decode_assignments_total"] += rows
            st["moe_decode_active_experts_total"] += active

    def _book_prefill(self, tokens, offset=0, cached=False):
        """A prefill call's work: ``tokens`` prompt positions computed
        after ``offset`` cached ones, each attending the prefix and its
        own call causally (no window); ``cached`` for the chunk read
        after a prefix (K2 on the card)."""
        st = self.stats
        pairs = tokens * offset + tokens * (tokens + 1) // 2
        st["prefill_tokens_total"] += tokens
        st["prefill_attn_pairs_total"] += pairs
        if cached:
            st["prefill_cached_tokens_total"] += tokens
            st["prefill_cached_prefix_total"] += offset
            st["prefill_cached_attn_pairs_total"] += pairs

    def _write_pages(self, layer, block_ids, k, v, shard=0):
        """Prefill cache fill, in place: ``k``/``v`` ``[P, kv, D]`` (the
        shard's local heads) padded with zeros to whole blocks and
        copied into this layer's pages ``block_ids`` of ``shard``'s
        pool, quantized when the pool is int8 (``generate.py:3304-3323``:
        the zero-padded pages go through ``kv_quantize``). The padded
        tail's K/V is masked by length at every later read."""
        n = block_ids.shape[0]
        rows = n * self.block_size
        pages = []
        for t in (k, v):
            page = torch.zeros((rows,) + tuple(t.shape[1:]),
                               dtype=t.dtype, device=t.device)
            page[:t.shape[0]] = t
            pages.append(page.view(n, self.block_size, *t.shape[1:]))
        for pool, page in zip(self._shards[shard].cache,
                              self._pool_rows(*pages)):
            pool[layer].index_copy_(0, block_ids, page)

    def _pool_rows(self, k, v):
        """K/V rows as the pool stores them: ``(k, v)``, or for an int8
        pool ``(k codes, v codes, k scales, v scales)``. k and v are
        quantized as one stacked tensor: the codes are row by row, so
        equal to two calls', in half the launches."""
        if self.kv_dtype != "int8":
            return k, v
        codes, scales = quantize_lib.kv_quantize(torch.stack((k, v)))
        return codes[0], codes[1], scales[0], scales[1]

    def _layer_pages(self, layer, shard=0):
        """One layer's slice of every component of ``shard``'s pool
        (``(k, v)`` or the int8 quadruple), the pool reads' ``pages``."""
        return tuple(pool[layer] for pool in self._shards[shard].cache)

    def _prefill_step(self, tokens, true_len, block_ids):
        """tokens [padded] → (first token, its fp32 logits or None).
        The padded tail sits causally after every real row, so the real
        rows — and the K/V written for them — are the bare prompt's."""
        c = self.config
        ids = self._on_devices(lambda d: torch.tensor(
            block_ids, dtype=torch.long, device=d))
        rope = self._on_devices(lambda d: transformer.rope_tables(
            c, torch.arange(tokens.shape[0], device=d)))
        xs = self._embed({d: t[None] for d, t in self._put(tokens).items()})
        tally = [] if self._moe else None
        for layer in range(c.n_layers):
            window, turn = c.layer_window(layer), c.layer_rope(layer)

            def attend(i, q, k, v):
                dev = self._shards[i].device
                if turn:
                    q = transformer.apply_rope(q, *rope[dev])
                    k = transformer.apply_rope(k, *rope[dev])
                o, _ = flash_ops.flash_attention(q, k, v, causal=True,
                                                 window=window)
                self._write_pages(layer, ids[dev], k[0], v[0], i)
                return o

            xs = self._layer(xs, layer, attend, tally)
        logits = self._head_logits(
            {d: x[:, true_len - 1] for d, x in xs.items()})[0]
        first = self._prefill_token(torch.argmax(logits), tally)
        self._book_prefill(true_len)
        dbg = logits.cpu().numpy() if self.debug_logits else None
        return first, dbg

    def _prefill_token(self, argmax, tally):
        """A prefill's first token off the device (an expert model's
        tally in the same copy, booked)."""
        out, *counts = self._tallied(tally, argmax)
        if tally is None:
            return int(out)
        out = out.cpu()
        self._book_moe(*counts, out[-1])
        return int(out[0])

    def _prefill_cached_step(self, tokens, true_len, offset, prefix_blocks,
                             block_ids):
        """Partial prefill (``generate.py:3365``): ``tokens [padded]``
        sit at positions ``offset + arange``, after ``offset`` cached
        positions held by ``prefix_blocks``; their K/V go to the fresh
        ``block_ids``. The rows read the prefix pages plus themselves
        causally (the chunk read, K2 on the card), so the K/V written and
        the token from the last real row are the cold prefill's.
        → the first generated token."""
        c = self.config
        n_rep = c.n_heads // c.kv_heads
        ids = self._on_devices(lambda d: torch.tensor(
            block_ids, dtype=torch.long, device=d))
        tables = np.zeros((1, self.blocks_per_slot), np.int32)
        tables[0, :len(prefix_blocks)] = prefix_blocks
        tables = self._put(tables)
        rope = self._on_devices(lambda d: transformer.rope_tables(
            c, offset + torch.arange(tokens.shape[0], device=d)))
        xs = self._embed({d: t[None] for d, t in self._put(tokens).items()})
        tally = [] if self._moe else None
        for layer in range(c.n_layers):
            window, turn = c.layer_window(layer), c.layer_rope(layer)

            def attend(i, q, k, v):
                dev = self._shards[i].device
                if turn:
                    q = transformer.apply_rope(q, *rope[dev])
                    k = transformer.apply_rope(k, *rope[dev])
                o = self._attn_chunk_read(q, self._layer_pages(layer, i),
                                          tables[dev], offset, k, v, n_rep,
                                          window)
                self._write_pages(layer, ids[dev], k[0], v[0], i)
                return o

            xs = self._layer(xs, layer, attend, tally)
        logits = self._head_logits(
            {d: x[:, true_len - 1] for d, x in xs.items()})[0]
        first = self._prefill_token(torch.argmax(logits), tally)
        self._book_prefill(true_len, offset, cached=True)
        return first

    @staticmethod
    def _rope_rows_fn(cos, sin, dtype):
        """``transformer.apply_rope`` at per-row positions
        (``generate.py:3530-3549``): ``cos``/``sin`` ``[S, D/2]`` for
        ``[S, 1, H, D]`` rows (decode, the draft's micro-steps) or
        ``[S, K1, D/2]`` for the verify's ``[S, K1, H, D]`` — the same
        pair rotation and stacking order, the tables cast to the compute
        dtype once per step."""
        c = cos.unsqueeze(-2).to(dtype)
        s = sin.unsqueeze(-2).to(dtype)
        if cos.dim() == 2:
            c, s = c[:, None], s[:, None]

        def rope_rows(t):
            x1, x2 = t[..., 0::2], t[..., 1::2]
            return torch.stack([x1 * c - x2 * s, x1 * s + x2 * c],
                               dim=-1).reshape(t.shape)

        return rope_rows

    def _write_kv(self, layer, phys, off, k, v, shard=0):
        """Decode and verify write, in place: K/V rows ``[n, kv, D]`` (the
        shard's local heads) into their pages of ``shard``'s pool at
        ``(phys, off)``, quantized when the pool is int8
        (``generate.py:3517-3524``). JAX drops its inactive and clamped
        rows' out-of-bounds sentinel writes (``mode="drop"``), which
        torch indexing would not: the verify passes only the rows to
        write, and the plain decode step sends its idle rows to the sink
        block."""
        for pool, t in zip(self._shards[shard].pool,
                           self._pool_rows(k, v)):
            pool[layer].index_put_((phys, off), t)

    def _gather_kv(self, pages, tables):
        """One layer's pool + tables → K/V in logical order
        ``[S, bps·block_size, kv_heads, head_dim]``; an int8 pool is
        widened by ``kv_dequantize`` (``generate.py:3419-3424``)."""
        S = tables.shape[0]
        T = self.blocks_per_slot * self.block_size
        idx = tables.long()
        kv = tuple(p[idx] for p in pages)
        if len(kv) == 4:
            dt = self.config.compute_dtype
            kv = (quantize_lib.kv_dequantize(kv[0], kv[2], dt),
                  quantize_lib.kv_dequantize(kv[1], kv[3], dt))
        return tuple(p.reshape(S, T, *p.shape[3:]) for p in kv)

    def _attn_decode_read(self, q, pages, tables, lengths, n_rep, window=0):
        """Backend dispatch for the decode read (``generate.py:3429``);
        ``window`` the layer's key window (paged reads only)."""
        if self.attn_backend == "gather":
            k_all, v_all = self._gather_kv(pages, tables)
            return attn_lib.decode_attention(
                q, attn_lib.repeat_kv(k_all, n_rep),
                attn_lib.repeat_kv(v_all, n_rep), lengths)
        # the split rule at the model's whole KV-head count: a shard's
        # key walk splits, and its partials merge, as the unsharded
        # engine's do
        return paged_ops.paged_decode_attention(
            q, pages, tables, lengths, block_size=self.block_size,
            n_rep=n_rep, split_heads=self.config.kv_heads, window=window)

    def _attn_chunk_read(self, q, pages, tables, prefix_len, k, v, n_rep,
                         window=0):
        """Backend dispatch for the multi-token chunk-after-prefix reads
        (``generate.py:3452``): the partial prefill's scalar offset and
        the verify's per-slot depths. ``gather`` materializes the prefix
        and runs ``attention.chunk_attention``; the paged backends run
        ``ops.paged_attention.paged_chunk_attention`` (K2)."""
        if self.attn_backend == "gather":
            pk, pv = self._gather_kv(pages, tables)
            return attn_lib.chunk_attention(
                q, attn_lib.repeat_kv(torch.cat([pk, k], dim=1), n_rep),
                attn_lib.repeat_kv(torch.cat([pv, v], dim=1), n_rep),
                prefix_len)
        return paged_ops.paged_chunk_attention(
            q, pages, tables, prefix_len, k, v,
            block_size=self.block_size, n_rep=n_rep,
            split_heads=self.config.kv_heads, window=window)

    def _step_views(self, buf):
        """The plain decode step's packed input ``buf`` (int32 ``[S·bps +
        5·S]``, numpy or torch) → its views: ``tables [S, bps]``, then
        ``lengths``, ``tokens``, the write's block and offset, and the
        active mask, each ``[S]``."""
        S, n = self.max_slots, self.max_slots * self.blocks_per_slot
        return (buf[:n].reshape(S, self.blocks_per_slot),
                *buf[n:].reshape(5, S))

    def _blank_step(self, buf):
        """``buf`` (numpy) with every row idle: it reads nothing and
        writes the sink block → ``buf``."""
        buf[:] = 0
        self._step_views(buf)[3][:] = self.num_blocks
        return buf

    def _graph_key(self):
        """What a captured step bakes in: the storage of the weights it
        reads (the stacked leaves, whose views the layers read; both are
        made together by ``_load_weights``) and of the pool."""
        return tuple(t.data_ptr() for sh in self._shards for t in (
            *(leaf for g in sh.params.values() if isinstance(g, dict)
              for leaf in g.values()), sh.params["embed"],
            sh.params["final_norm"],
            *(() if sh.head is None else (sh.head,)), *sh.pool))

    def _decode_launch(self):
        """Queue the plain decode step over ``_step_in`` → (next tokens
        [S], fp32 logits [S, V]) on the first device. On one card: one
        copy of the input and one replay of the captured step (captured
        first where there is none over these weights and this pool);
        elsewhere the step's launches, eagerly."""
        if not self._graphable:
            return self._decode_step(self._on_devices(
                lambda d: self._step_in.to(d, non_blocking=True)))
        g = self._graph
        if g is None or g.key != self._graph_key():
            return self._capture()
        g.inputs.copy_(self._step_in, non_blocking=True)
        g.graph.replay()
        self.stats["decode_graph_replays"] += 1
        for fn, attr, n in g.launches:
            setattr(fn, attr, getattr(fn, attr) + n)
        return g.outputs

    def _capture(self):
        """This step, run eagerly on a side stream (its tokens are the
        step's), then captured as a CUDA graph into a private memory pool
        over a static copy of its input → the eager run's (next tokens,
        logits). Nothing runs while capturing, so the launch counters
        are put back to where the eager run left them, and each replay
        adds what the capture counted."""
        t0, t0w = time.perf_counter(), time.time()
        dev = self.device
        self._graph = None              # the old graph's pool goes first
        inputs = self._step_in.to(dev, non_blocking=True)
        main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            outputs = self._decode_step({dev: inputs})
        main.wait_stream(side)
        before = [getattr(fn, attr) for fn, attr in _LAUNCH_COUNTERS]
        graph = torch.cuda.CUDAGraph()
        # thread-local: the transport's threads may touch the card too
        with torch.cuda.device(dev), torch.cuda.graph(
                graph, stream=torch.cuda.Stream(dev),
                capture_error_mode="thread_local"):
            static = self._decode_step({dev: inputs})
        launches = []
        for (fn, attr), n in zip(_LAUNCH_COUNTERS, before):
            if getattr(fn, attr) != n:
                launches.append((fn, attr, getattr(fn, attr) - n))
                setattr(fn, attr, n)
        self._graph = _DecodeGraph(self._graph_key(), graph, inputs,
                                   static, tuple(launches))
        self.stats["decode_graph_captures"] += 1
        self.stats["decode_graph_capture_seconds_total"] += \
            time.perf_counter() - t0
        self.trace.record("engine.decode.capture", t0w, time.time())
        return outputs

    def _decode_step(self, ins):
        """One token for every slot over the packed step input ``ins``
        (``{device: int32 tensor}``, :meth:`_step_views`) → (next tokens
        [S], fp32 logits [S, V]) on the first device, queued, not waited
        for. Every row writes its input token's K/V (an idle row into the
        sink block), THEN reads ``(length + 1) · active`` positions (its
        own included): idle rows read nothing and their outputs are
        discarded. Fixed shapes, and no host memory touched: this is
        what the decode graph captures. An expert model's tokens carry
        the step's active-expert tally as an ``[S + 1]``-th entry; its
        host counts, the same every step, are kept in ``_step_tally``."""
        c = self.config
        n_rep = c.n_heads // c.kv_heads

        def inputs(dev):
            tables, lengths, tokens, phys, off, live = self._step_views(
                ins[dev])
            rope_rows = self._rope_rows_fn(
                *transformer.rope_tables(c, lengths), c.compute_dtype)
            return tables, tokens, phys, off, (lengths + 1) * live, \
                rope_rows

        ins = self._on_devices(inputs)
        xs = self._embed({d: v[1][:, None] for d, v in ins.items()})
        tally = [] if self._moe else None
        for layer in range(c.n_layers):
            window, turn = c.layer_window(layer), c.layer_rope(layer)

            def attend(i, q, k, v):
                tables, _, phys, off, read_lengths, rope_rows = \
                    ins[self._shards[i].device]
                if turn:
                    q, k = rope_rows(q), rope_rows(k)
                self._write_kv(layer, phys, off, k[:, 0], v[:, 0], i)
                return self._attn_decode_read(
                    q, self._layer_pages(layer, i), tables, read_lengths,
                    n_rep, window)

            xs = self._layer(xs, layer, attend, tally)
        logits = self._head_logits({d: x[:, 0] for d, x in xs.items()})
        nxt, *counts = self._tallied(tally, torch.argmax(logits, dim=-1))
        if tally is not None:
            self._step_tally = tuple(counts)
        return nxt, logits

    def _draft_prefill_step(self, prompt, slot_idx):
        """Fill the draft's dense cache row of ``slot_idx`` from the
        bucket-padded full prompt (``generate.py:3590``): one causal
        forward through the draft (plain ``attention.dense_attention``,
        as JAX runs it with XLA), K/V written at positions
        ``0..padded-1``. The padded
        tail's K/V sits past the prompt, where every read is
        length-masked until the proposals overwrite it. Emits nothing:
        the first token is the target's."""
        c = self.draft_config
        dev = self.device
        n_rep = c.n_heads // c.kv_heads
        padded = self._suffix_padded(len(prompt), 0)
        tokens = np.zeros((padded,), np.int64)
        tokens[:len(prompt)] = prompt
        x = self.draft_params["embed"][torch.from_numpy(tokens).to(dev)][None]
        cos, sin = transformer.rope_tables(
            c, torch.arange(padded, device=dev))
        dk, dv = self._draft_cache
        for layer, lp in enumerate(self._draft_layers):
            def attend(q, k, v):
                q = transformer.apply_rope(q, cos, sin)
                k = transformer.apply_rope(k, cos, sin)
                o = attn_lib.dense_attention(
                    q, attn_lib.repeat_kv(k, n_rep),
                    attn_lib.repeat_kv(v, n_rep), causal=True)
                dk[layer, slot_idx, :padded] = k[0]
                dv[layer, slot_idx, :padded] = v[0]
                return o, None

            x, _, _ = transformer.layer_core(x, lp, attend, c)

    def _propose_step(self, tokens, lengths, limits):
        """Draft proposal (``generate.py:3626``): ``spec_k`` greedy
        tokens per slot from ``spec_k + 1`` autoregressive micro-steps
        over the draft's dense cache, read with the plain
        ``attention.decode_attention``. The extra micro-step only writes
        the last proposal's K/V, so after any acceptance the draft cache
        is valid through the target's new length. Row ``i`` writes
        positions up to ``limits[i]``; later writes and every inactive
        row's are filtered out (JAX drops them out of bounds).
        → proposals ``[S, spec_k]`` numpy."""
        c = self.draft_config
        dev = self.device
        n_rep = c.n_heads // c.kv_heads
        dk, dv = self._draft_cache
        tok = torch.from_numpy(tokens).to(dev)
        pos = torch.from_numpy(lengths).to(dev).long()
        props = []
        for step in range(self.spec_k + 1):
            rows = torch.from_numpy(
                np.flatnonzero(lengths + step <= limits)).to(dev)
            wpos = pos[rows]
            x = self.draft_params["embed"][tok][:, None]
            rope_rows = self._rope_rows_fn(
                *transformer.rope_tables(c, pos), c.compute_dtype)
            for layer, lp in enumerate(self._draft_layers):
                def attend(q, k, v):
                    q, k = rope_rows(q), rope_rows(k)
                    dk[layer].index_put_((rows, wpos), k[rows, 0])
                    dv[layer].index_put_((rows, wpos), v[rows, 0])
                    o = attn_lib.decode_attention(
                        q, attn_lib.repeat_kv(dk[layer], n_rep),
                        attn_lib.repeat_kv(dv[layer], n_rep), pos + 1)
                    return o, None

                x, _, _ = transformer.layer_core(x, lp, attend, c)
            if step == self.spec_k:
                break              # this step ran for its cache write
            x = transformer._rmsnorm(x[:, 0],
                                     self.draft_params["final_norm"])
            tok = torch.argmax(transformer._logits(x, self._draft_head),
                               dim=-1)
            props.append(tok)
            pos = pos + 1
        return torch.stack(props, dim=1).cpu().numpy()

    def _verify_step(self, tables, lengths, tokens, writes):
        """Score all ``k + 1`` candidate positions of every slot in one
        target forward (``generate.py:3681``): ``tokens[i]`` =
        ``[last_token, d_1..d_k]`` at positions ``lengths[i] + arange``;
        their K/V go to the pool at ``writes`` (row, column, block,
        offset — clamped positions are left out), and the read is the
        chunk read with the per-slot prefix depth ``lengths`` (K2).
        → the target's argmax per position ``[S, k+1]`` numpy."""
        c = self.config
        n_rep = c.n_heads // c.kv_heads
        tables_t = self._put(tables)
        K1 = tokens.shape[1]

        def inputs(dev):
            lengths_t = torch.from_numpy(lengths).to(dev)
            positions = (lengths_t[:, None].long()
                         + torch.arange(K1, device=dev))
            rope_rows = self._rope_rows_fn(
                *transformer.rope_tables(c, positions), c.compute_dtype)
            return (lengths_t, torch.from_numpy(writes).to(dev),
                    rope_rows)

        ins = self._on_devices(inputs)
        xs = self._embed(self._put(tokens))
        for layer in range(c.n_layers):
            def attend(i, q, k, v):
                dev = self._shards[i].device
                lengths_t, (rows, cols, phys, off), rope_rows = ins[dev]
                q, k = rope_rows(q), rope_rows(k)
                self._write_kv(layer, phys, off, k[rows, cols],
                               v[rows, cols], i)
                if self.kv_dtype == "int8":
                    # plain decode reads every position, its own token
                    # included, back through the int8 pool: the verify
                    # attends over the same round-tripped chunk values
                    # (generate.py:3711-3721), or speculative int8
                    # output leaves plain int8 output
                    k, v = quantize_lib.kv_dequantize(
                        *quantize_lib.kv_quantize(torch.stack((k, v))),
                        c.compute_dtype)
                return self._attn_chunk_read(
                    q, self._layer_pages(layer, i), tables_t[dev],
                    lengths_t, k, v, n_rep)

            xs = self._layer(xs, layer, attend)
        logits = self._head_logits(xs)
        return torch.argmax(logits, dim=-1).cpu().numpy()


def truncated_draft(params, config, draft_layers, dampen=None):
    """Self-speculative draft pair (``generate.py:3735``): the draft is
    the target's first ``draft_layers`` layers sharing its embed, final
    norm and LM head. ``dampen`` also returns a modified target whose
    layers ``>= draft_layers`` have ``wo`` and ``w_down`` scaled by that
    factor, so the draft's argmax usually survives the upper layers and
    acceptance is measurable without a training run.

    → ``(target_params, draft_params, draft_config)``; the target is
    ``params`` itself when ``dampen`` is None. The tensors stay on
    their device; ``config`` is the port's frozen ``Config``."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        layers = {k: torch.stack([lp[k] for lp in layers])
                  for k in layers[0]}
        params = {**params, "layers": layers}
    if not 1 <= int(draft_layers) < config.n_layers:
        raise ValueError(
            f"draft_layers must be in [1, {config.n_layers - 1}] (a "
            f"strict prefix of the target's {config.n_layers} layers), "
            f"got {draft_layers}")
    draft_layers = int(draft_layers)
    draft_config = dataclasses.replace(config, n_layers=draft_layers)
    draft_params = {k: v for k, v in params.items() if k != "layers"}
    draft_params["layers"] = {k: a[:draft_layers] for k, a in layers.items()}
    if dampen is not None:
        damped = dict(layers)
        for key in ("wo", "w_down"):
            a = layers[key]
            mult = torch.ones((config.n_layers,), dtype=torch.float32,
                              device=a.device)
            mult[draft_layers:] = float(dampen)
            damped[key] = a * mult.reshape(
                (-1,) + (1,) * (a.dim() - 1)).to(a.dtype)
        params = {**params, "layers": damped}
    return params, draft_params, draft_config


def reference_greedy_decode(params, config, prompt, max_tokens,
                            eos_id=None, collect_logits=False):
    """The conformance oracle: greedy decode by FULL-CONTEXT recompute
    through the model at every step — O(n²) and cache-free. Runs on the
    params' device, at one fixed padded length (the trailing pad sits
    causally after every real position, so the real rows are the bare
    prompt's). ``collect_logits=True`` also returns each step's fp32
    ``[vocab]`` row — ``(tokens, rows)``."""
    dev = params["embed"].device
    p = transformer.cast_params(params, config.compute_dtype)
    head = p["head"].float()
    tokens = [int(t) for t in prompt]
    out, rows = [], []
    pad_to = max(config.max_seq, len(tokens) + max_tokens)
    buf = torch.zeros((1, pad_to), dtype=torch.long, device=dev)
    with torch.no_grad():
        for _ in range(max_tokens):
            buf[0, :len(tokens)] = torch.tensor(tokens, device=dev)
            x, _ = transformer.backbone(p, buf, config)
            row = transformer._logits(x[0, len(tokens) - 1], head)
            row = row.cpu().numpy()
            nxt = int(row.argmax())
            if collect_logits:
                rows.append(row)
            out.append(nxt)
            tokens.append(nxt)
            if eos_id is not None and nxt == eos_id:
                break
    return (out, rows) if collect_logits else out
