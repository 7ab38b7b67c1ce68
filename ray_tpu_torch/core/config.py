"""Typed, env-overridable config registry.

Parity with the reference's flat-file config (`src/ray/common/
ray_config_def.h:18` — 181 RAY_CONFIG entries, overridable via RAY_<name> env
vars and `ray.init(_system_config=...)`). Here: declare once, override via
`RAY_TPU_TORCH_<NAME>` env vars or `init(_system_config={...})`.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
from typing import Any

logger = logging.getLogger(__name__)

_ENV_PREFIX = "RAY_TPU_TORCH_"


def _env(name: str, typ, default):
    raw = os.environ.get(_ENV_PREFIX + name.upper())
    if raw is None:
        return default
    if typ is bool:
        return raw.lower() in ("1", "true", "yes")
    return typ(raw)


@dataclasses.dataclass
class Config:
    # --- object store ---
    # Objects <= this many bytes are inlined in RPCs instead of going through
    # shared memory (ref: ray_config_def.h:210 max_direct_call_object_size).
    max_inline_object_size: int = 100 * 1024
    # Per-node shared-memory store capacity.
    object_store_memory: int = 2 * 1024**3
    # Chunk size for node-to-node object transfer
    # (ref: ray_config_def.h:329 object_manager_default_chunk_size = 5 MiB).
    object_transfer_chunk_size: int = 5 * 1024**2
    # Fraction of store capacity above which spilling kicks in.
    object_spill_threshold: float = 0.8
    # Directory for spilled objects (under session dir if relative).
    spill_dir: str = "spilled_objects"
    # Cadence of a raylet's directory re-check while a store_get waits for
    # a missing object (each round may trigger a pull / recovery).
    object_pull_retry_interval_s: float = 1.0
    # Concurrent chunk fetches within one object pull (windowed transfer).
    object_pull_parallelism: int = 4
    # Outbound serve slots per object (broadcast fan-out tree: pullers
    # beyond this bound retry the directory, where completed pullers have
    # registered as fresh holders — ref: push_manager.h:29).
    object_serve_fanout: int = 3
    # Reclaim a serve slot whose puller died after this long.
    object_serve_slot_ttl_s: float = 120.0
    # Initial backoff between directory re-checks inside one pull attempt
    # (doubles up to object_pull_retry_interval_s).
    object_pull_backoff_s: float = 0.1
    # Fraction of store capacity one admitted pull may occupy; larger
    # pulls queue until space frees (create-queue backpressure,
    # ref: plasma create_request_queue.cc).
    pull_admission_fraction: float = 0.25
    # Busy-poll cadence of a blocking ray_tpu_torch.wait() between readiness
    # re-checks.
    wait_poll_interval_s: float = 0.005

    # --- scheduling ---
    # Hybrid policy: pack onto nodes below this utilization, then spread
    # (ref: raylet/scheduling/policy/hybrid_scheduling_policy.h:24-47).
    hybrid_threshold: float = 0.5
    # Max workers spawned per node beyond num_cpus (soft cap).
    max_workers_per_node: int = 64
    # Prestarted idle workers per node.
    prestart_workers: int = 0
    # Concurrent lease lanes per scheduling key (ref: the per-SchedulingKey
    # submitter pipeline, direct_task_transport.cc:108-220). Each lane holds
    # one lease and runs queued same-shape tasks back-to-back. Must exceed
    # the largest gang of same-key tasks that block on each other
    # (host-rendezvous collectives): serialized gang members deadlock.
    max_lease_lanes_per_key: int = 128
    # How long a drained lease lane keeps its worker before releasing —
    # sync call chains and back-to-back batches reuse the lease without a
    # fresh raylet round trip (ref: worker_lease_timeout_milliseconds).
    lease_keepalive_s: float = 0.2
    # Seconds an idle worker survives before reaping.
    idle_worker_ttl_s: float = 300.0

    # --- memory protection (ref: common/memory_monitor.h:48 +
    #     raylet/worker_killing_policy.h:58 RetriableLIFO) ---
    # Host memory-usage fraction above which the raylet kills workers.
    memory_usage_threshold: float = 0.95
    # Optional absolute cap on the summed RSS of this node's workers
    # (bytes; 0 = disabled). Mainly for tests and co-tenant machines.
    memory_limit_bytes: int = 0
    # Monitor period; 0 disables the monitor entirely.
    memory_monitor_period_s: float = 1.0

    # --- fault tolerance ---
    # Heartbeat period and miss budget
    # (ref: ray_config_def.h:55,63 num_heartbeats_timeout=30).
    heartbeat_period_s: float = 0.5
    heartbeat_miss_limit: int = 10
    # Default task retries / actor restarts
    # (ref: _private/ray_option_utils.py:118,158).
    default_max_retries: int = 3
    default_max_restarts: int = 0
    # Worker lease request timeout.
    lease_timeout_s: float = 60.0

    # --- reference counting / object GC ---
    # Automatic distributed ref counting (ref: reference_count.h:61). When
    # off, objects persist until explicit ray_tpu_torch.free.
    ref_counting_enabled: bool = True
    # Batched acquire/release flush period per client.
    ref_flush_interval_s: float = 0.1
    # Grace after a holder's GCS connection drops before its holds are
    # released (a reconnecting holder re-registers within this window).
    ref_holder_grace_s: float = 10.0
    # Lineage reconstruction (ref: object_recovery_manager.h:41): rebuild
    # lost objects by re-executing their creating tasks, transitively.
    lineage_reconstruction_enabled: bool = True
    # store_get probe window while a get() waits: every interval the client
    # re-checks liveness and triggers recovery for owned lost objects.
    get_probe_interval_s: float = 10.0
    # Poll cadence while a task waits on a FOREIGN (cross-client) ref to
    # appear in the object directory before dispatch.
    foreign_dep_poll_interval_s: float = 0.3
    # How long a worker retries its pre-reply ref flush before replying
    # with unflushed acquires (the submitter then defers escrow release).
    worker_preflush_window_s: float = 10.0

    # --- rpc ---
    rpc_connect_timeout_s: float = 10.0
    rpc_max_frame_bytes: int = 512 * 1024**2
    # GCS failover: how long raylets/clients keep retrying through a GCS
    # restart (ref: ray_config_def.h:70
    # gcs_failover_worker_reconnect_timeout).
    gcs_reconnect_window_s: float = 60.0
    # Delay between reconnect attempts inside that window.
    gcs_reconnect_backoff_s: float = 0.5

    # Remote driver ("ray://") mode: the client cannot mmap the node's
    # /dev/shm arena, so object data rides the RPC connection instead
    # (ref: util/client/ARCHITECTURE.md — here no proxy process is needed;
    # the control plane is already plain TCP). Single-frame transfers:
    # objects up to rpc_max_frame_bytes.
    remote_object_plane: bool = False
    # Remote drivers (ray://) stream objects bigger than this in chunks
    # instead of one RPC frame (the reference's client proxies arbitrarily
    # large objects via plasma chunking, util/client/).
    remote_object_chunk_bytes: int = 64 * 1024**2
    # Per-chunk RPC deadline and whole-object deadline for those streams.
    remote_chunk_rpc_timeout_s: float = 300.0
    remote_object_op_timeout_s: float = 600.0

    # Stream worker stdout/stderr (user prints) to connected drivers
    # (ref: _private/log_monitor.py:100 → driver prints).
    log_to_driver: bool = True

    # --- GCS durability (ref: gcs/store_client/redis_store_client.h — the
    #     reference persists every table write to Redis; here a per-mutation
    #     WAL + periodic snapshot compaction) ---
    # Snapshot compaction period; the WAL makes the interval a compaction
    # knob, not a durability window (r1 lost everything since the last tick).
    gcs_snapshot_interval_s: float = 10.0
    # fsync each WAL append (survives machine crash, not just process kill).
    gcs_wal_fsync: bool = False

    # --- background loop cadences + stock RPC deadlines (promoted hot
    #     literals, ref: ray_config_def.h's timer section) ---
    # Idle-worker reap sweep cadence in the raylet.
    raylet_idle_reap_interval_s: float = 5.0
    # Raylet log-directory scan cadence (log streaming to drivers).
    raylet_log_scan_interval_s: float = 0.5
    # Worker profile-span flush cadence to the GCS.
    worker_profile_flush_interval_s: float = 1.0
    # Stock deadline for intra-cluster control RPCs that have no
    # tighter site-specific bound.
    rpc_default_timeout_s: float = 10.0
    # GCS (re)connect + node re-registration deadline.
    gcs_register_timeout_s: float = 30.0

    # --- autoscaler ---
    # How long a launched node may take to register with the GCS before
    # the reconciler writes it off and relaunches.
    autoscaler_boot_timeout_s: float = 300.0

    # --- train gang rendezvous ---
    # jax.distributed.initialize connection window for a worker gang.
    train_rendezvous_timeout_s: float = 300.0
    # XLA CPU-collective op timeout (--xla_cpu_collective_timeout_seconds;
    # XLA's default 30s trips on compile skew between gang members when
    # the host is loaded).
    train_cpu_collective_timeout_s: float = 180.0

    # --- serve control plane (ref: serve/_private/deployment_state.py +
    #     gcs/gcs_server/gcs_health_check_manager.cc:1 — probes fail a
    #     replica only after `failure_threshold` consecutive misses) ---
    # Reconcile loop cadence.
    serve_reconcile_interval_s: float = 0.5
    # Per-probe health/stats RPC timeout.
    serve_health_probe_timeout_s: float = 10.0
    # Consecutive failed probes before a replica is considered dead. A
    # single timed-out probe on a loaded box must not reap a healthy
    # replica (definitive actor death still reaps immediately).
    serve_health_failure_threshold: int = 3
    # How long a STARTING replica may take to answer its first health
    # probe before it is killed and replaced (ref: deployment_state.py
    # STARTING → RUNNING transition; only RUNNING replicas are routable).
    serve_replica_start_timeout_s: float = 180.0
    # After a cold start from zero replicas, do not scale back below one
    # replica for this long — the waking request needs time to land
    # (handle-side demand is invisible to replica stats until then).
    serve_cold_start_grace_s: float = 10.0
    # HTTP ingress admission cap: in-flight requests beyond this get 503
    # (bounded queueing; overload surfaces to clients).
    serve_http_max_inflight: int = 1024
    # Per-request end-to-end timeout at the ingress.
    serve_http_request_timeout_s: float = 120.0
    # Largest request body the ingress will buffer (413 beyond it).
    serve_http_max_body_bytes: int = 64 * 1024**2
    # Open-connection cap per ingress proxy (memory bound under overload:
    # at most max_connections × max_body_bytes buffered).
    serve_http_max_connections: int = 2048
    # Idle keep-alive read deadline at the ingress (header/body waits).
    serve_http_idle_timeout_s: float = 300.0
    # Handle routing-table staleness safety net (push is primary; this
    # bounds how long a lost notify can serve a stale replica list).
    serve_handle_refresh_ttl_s: float = 10.0
    # How long a handle waits for the first replica of a scale-from-zero
    # cold start before failing the request.
    serve_cold_start_timeout_s: float = 60.0

    # --- serve fault tolerance (drain / failover) ---
    # How long a replica shed by scale-down or a version roll may spend
    # finishing its in-flight work before the controller hard-kills it.
    # The replica's drain() stops admission, lets live decodes finish,
    # and exports whatever remains as resumable continuations; <= 0
    # restores the legacy hard-kill behavior.
    serve_drain_timeout_s: float = 30.0
    # Failover retries per request at the proxies/handles: on a replica
    # death or drain rejection the request is resubmitted to a re-picked
    # replica (streams resume from their cursor with already-emitted
    # tokens teacher-forced) this many times before the client sees an
    # error.
    serve_failover_attempts: int = 3
    # Controller checkpoint write: bounded retries with exponential
    # backoff so one transient GCS blip doesn't silently cost the next
    # controller restart its state.
    serve_ckpt_write_retries: int = 4
    serve_ckpt_write_backoff_s: float = 0.2

    # --- serve router (load-aware + prefix-affine replica selection) ---
    # How handles/proxies pick a replica per request:
    #   p2c_local  power-of-two-choices on the handle's OWN outstanding
    #              counts only — byte-for-byte the legacy router.
    #   p2c_load   (default) power-of-two-choices on a BLENDED score:
    #              handle-local inflight + the replica's last-probed
    #              ongoing (inflight + queued), staleness-decayed. The
    #              controller pushes the per-replica load table to
    #              handles alongside the routing table on every
    #              reconcile, so the signal is cluster-wide, not
    #              handle-local.
    #   affinity   p2c_load plus prefix-affine placement: requests
    #              whose prompt hashes to a warm replica (rendezvous
    #              hash over the chunk-chain head) route there unless
    #              its blended load crosses the spill threshold.
    serve_router_policy: str = "p2c_load"
    # Probed-load staleness horizon: a probe older than this contributes
    # nothing to the blended score (linear decay in between), so a
    # lagging probe can never blackhole traffic onto one replica.
    serve_router_load_stale_s: float = 5.0
    # Affinity spill threshold: when the preferred (prefix-affine)
    # replica's blended load reaches this many ongoing requests, the
    # request spills to the load-balanced pick instead — affinity must
    # never defeat load balancing.
    serve_router_spill_ongoing: float = 16.0
    # --- overload shedding (proxy admission, per deployment) ---
    # When the autoscaler's recommendation is pinned at max_replicas and
    # every replica's last-probed queue depth exceeds this, the proxy
    # sheds new requests with a typed 503 + Retry-After instead of
    # letting TTFT burn unboundedly. 0 disables shedding.
    serve_overload_queue_depth: int = 32
    # Retry-After value handed to shed clients.
    serve_overload_retry_after_s: float = 1.0

    # --- LLM serving engine ---
    # Fused decode window: tokens generated per device dispatch with
    # on-device sampling. The dominant knob when dispatch latency is
    # non-trivial (remote tunnel, loaded host); 1 = per-token dispatch.
    llm_decode_block: int = 8
    # Finished-but-unread token streams are garbage-collected after this.
    llm_stream_ttl_s: float = 600.0
    # KV layout: "dense" preallocates [n_slots, max_len] per slot;
    # "paged" shares a page pool with per-slot tables + ragged attention
    # reads (models/paged_kv.py) — more slots per GB, preempt-by-
    # recompute under pressure. BENCH_SERVE.json measures the trade.
    llm_kv_mode: str = "dense"
    # Tokens per KV page in paged mode.
    llm_kv_page_size: int = 64
    # Paged-decode attention implementation: "gather" (the kernels' plain
    # PyTorch versions) | "kernel" (the CUDA paged-attention kernels: K/V
    # pages read in place with online softmax) | "auto" (resolve at
    # engine init: "kernel" on a CUDA device, "gather" on the CPU — one
    # fleet-wide export serves both). The port's default is "auto", the
    # one field whose default differs from the JAX runtime's ("gather"):
    # its kernels are the path on the card. Env:
    # RAY_TPU_TORCH_LLM_ATTN_IMPL=gather.
    llm_attn_impl: str = "auto"
    # Chunked prefill (paged mode only): prompts enter their slot's page
    # table in fixed-size chunks co-scheduled against decode instead of
    # one whole-prompt prefill per admission. 0 = one-shot bucketed
    # admission (legacy). >0 = chunk size in tokens; every chunk of every
    # prompt length lowers the SAME two programs (interior + final), so
    # the prefill compile grid collapses from buckets × admission-ladder
    # to 2. Env: RAY_TPU_TORCH_LLM_PREFILL_CHUNK=64.
    llm_prefill_chunk: int = 0
    # Width-bucketed chunk dispatch (paged + chunked engines): chunk rows
    # group by the pow-2 page width each row actually attends over
    # (pages covering written tokens + this chunk — the `_pow2_width`
    # rule shared with the decode table view), and every dispatch
    # carries a table sliced to its bucket's width instead of the full
    # max_pages_per_slot — interior chunks of a long-max-len engine stop
    # paying attention bytes ∝ max_len. Programs lower per (width, head)
    # pair: ≤ 2·log₂(max_pages)+2 total, pre-compiled by the engine's
    # bucket-ladder warmup (start()/warmup_compile()). False = every
    # chunk dispatch carries the full-width table (the two-program
    # grid; the bench ablation's control arm).
    # Env: RAY_TPU_TORCH_LLM_PREFILL_WIDTH_BUCKETING=0.
    llm_prefill_width_bucketing: bool = True
    # Bucket-ladder compile warmup at engine start(): pre-compile every
    # (width, head) chunk-program variant — and the verify/draft ladder
    # when speculation is on — before serving traffic, so a measured
    # window pays zero XLA compiles (`jax_compiles_delta == 0`) no
    # matter which widths traffic happens to hit first. Costs
    # ~log₂(max_pages)+1 compiles per program at boot (marked via
    # compile_watch.warmup_scope() so the recompile-storm detector stays
    # quiet). Default off: short-lived engines (tests, notebooks) are
    # better served compiling lazily; serving deployments and benches
    # turn it on (benches may also call engine.warmup_compile()
    # directly). Env: RAY_TPU_TORCH_LLM_WARMUP_COMPILE=1.
    llm_warmup_compile: bool = False
    # Max prefill tokens one engine tick may run while decode is active
    # (the decode-stall bound: a tick's prefill work never exceeds this).
    # 0 = pure-decode ticks (prefill only advances while nothing is
    # decoding); otherwise must be >= llm_prefill_chunk. Ignored unless
    # llm_prefill_chunk > 0.
    llm_prefill_token_budget: int = 256
    # Paged-KV prefix cache (serve/prefix_cache.py): completed requests
    # donate their chunk-aligned prefix pages (refcounted, read-only)
    # and admission binds the longest cached prefix into a new slot's
    # page table — chunked prefill then starts at the first COLD token,
    # so warm-prefix TTFT collapses to the cold suffix + first decode.
    # Requires kv_mode="paged" AND llm_prefill_chunk > 0 (the cache
    # granularity IS the prefill chunk). Env: RAY_TPU_TORCH_LLM_PREFIX_CACHE=1.
    llm_prefix_cache: bool = False
    # Max distinct pool pages cache entries may pin (the budget a
    # pressure-aware LRU evicts against; zero-ref entries are always
    # evicted before the scheduler preempts a live decode). 0 = auto:
    # half the page pool.
    llm_prefix_cache_pages: int = 0
    # Speculative decoding (serve/llm.py): draft model name (GPTConfig
    # registry, e.g. "tiny") whose proposals the target verifies in ONE
    # batched chunked-prefill pass per tick (models/paged_kv.py
    # verify_chunk_paged — the chunk program IS the verify program).
    # Rejection sampling keeps greedy output byte-identical to
    # non-speculative decode and temperature>0 distributionally exact.
    # "" = off. Requires kv_mode="paged" AND llm_prefill_chunk > 0;
    # alongside an incompatible engine the global knob soft-disables
    # (explicit constructor args still error, like llm_prefill_chunk).
    # NOTE: this knob names the draft ARCHITECTURE only — supply trained
    # draft weights via LLMEngine(spec_draft_params=...) or
    # LLMDeployment(spec_draft_checkpoint=...); a random-init draft has
    # ~zero acceptance, making every tick strictly slower than
    # non-speculative decode. Env: RAY_TPU_TORCH_LLM_SPEC_DRAFT=tiny.
    llm_spec_draft: str = ""
    # Draft tokens proposed per active slot per engine tick (>= 1). The
    # verify chunk is k+1 tokens wide; each tick emits between 1 (first
    # proposal rejected) and k+1 (all accepted + bonus) tokens per slot.
    llm_spec_k: int = 4
    # Tensor-parallel decode (models/partition.py): shards params
    # (regex→PartitionSpec rules, gpt.partition_rules) and the paged KV
    # pool along the HEAD axis over a ("tp",) mesh of local devices;
    # every paged program runs per-shard via shard_map with only the
    # per-layer attention-out/MLP-down psums crossing shards. 1 =
    # single-chip engine, byte-for-byte. Requires kv_mode="paged" AND
    # llm_prefill_chunk > 0; must divide n_heads and d_ff (target and
    # draft) and fit the visible device count — on ANY misfit
    # (incompatible engine, too few devices, non-divisor) the global
    # knob soft-disables to 1 so a fleet-wide export can't crash a
    # replica boot; explicit constructor args still raise typed errors,
    # like llm_prefill_chunk. Off-TPU:
    # XLA_FLAGS=--xla_force_host_platform_device_count=N forks virtual
    # host devices (TESTING.md). Env: RAY_TPU_TORCH_LLM_TP=2.
    llm_tp: int = 1
    # Quantized serving — weight stream (models/gpt.quantize_params):
    # "bf16" (storage as loaded, the default) | "int8" (per-output-channel
    # symmetric int8 matmul planes + fp32 scale vectors; dequant fuses at
    # the consuming einsum via gpt.weight_view — the fp32 plane is never
    # re-materialized in HBM; norms/embeddings/biases stay float).
    # Requires kv_mode="paged"; alongside an incompatible engine the
    # global knob soft-disables (explicit constructor args still raise,
    # like llm_prefill_chunk). Env: RAY_TPU_TORCH_LLM_WEIGHT_DTYPE=int8.
    llm_weight_dtype: str = "bf16"
    # Quantized serving — KV stream (models/paged_kv.init_paged_kv):
    # "bf16" (pool planes in cfg.dtype, the default) | "int8" (int8 page
    # planes + per-page scale planes [L, P+1] riding the same page
    # tables; scales are frozen at each page's first write, so COW /
    # donation / adoption / drain stay pure page-id plumbing with zero
    # scheduler or refcount changes). Same gating + soft-off/strict
    # split as llm_weight_dtype. Env: RAY_TPU_TORCH_LLM_KV_DTYPE=int8.
    llm_kv_dtype: str = "bf16"
    # KV page-set transfer (serve/kv_objects.py): completed prefills and
    # drain exports donate their written KV pages as refcounted,
    # chunk-chain-keyed page-set objects; an admitting engine ADOPTS
    # resolvable page sets by reference instead of re-prefilling
    # (failover ladder: adopt → partial-adopt + cold-suffix prefill →
    # teacher-forced re-prefill). Requires kv_mode="paged" AND
    # llm_prefill_chunk > 0 (page-aligned chunks); llm_tp > 1 engines
    # donate per-shard head planes and adopters reshard at bind time
    # (partition.split_head_planes/concat_head_planes), so tp composes.
    # On any misfit the GLOBAL knob soft-disables (a fleet-wide export
    # must not crash replica boot) while explicit constructor args raise
    # typed errors, like llm_prefill_chunk. Forced on by pool_role
    # (disaggregated prefill/decode pools — the handoff IS a donation +
    # adoption).
    llm_kv_transfer: bool = False
    # Max page-set entries one donor engine keeps alive (oldest
    # donations are withdrawn first — their objects freed and index
    # entries dropped — so a long-lived donor can't pin the object
    # store full of stale KV).
    serve_kv_object_budget: int = 64
    # Donated page-set lifetime: the controller's orphan sweep frees
    # entries older than this, and entries whose donor replica is no
    # longer a member of any deployment (dead donors can't leak pages).
    serve_kv_object_ttl_s: float = 120.0
    # Cadence of the controller-side orphan sweep (full reconcile
    # passes only).
    serve_kv_sweep_interval_s: float = 10.0
    # Hard cap on the per-replica donated-chain-head summary that rides
    # load_snapshot() → the controller's routing push (descriptor-less
    # warm discovery): at most this many chain heads per replica, newest
    # kept — an oversized summary degrades to truncation, never an
    # unbounded push (the 100-replica control-plane soak bound). Also
    # bounds the engine-side donation memo the summary is read from.
    serve_kv_summary_max: int = 128

    # --- flight recorder (compile watch + SLO monitor) ---
    # Recompile-storm alarm (ray_tpu/compile_watch.py): a structured
    # `recompile.storm` cluster event fires when one traced program label
    # compiles more than `threshold` times inside the rolling window —
    # the production alarm for silent per-step recompile churn (the
    # decode-table-width class of bug).
    jax_recompile_storm_threshold: int = 10
    jax_recompile_storm_window_s: float = 120.0
    # Default SLO objectives (ray_tpu/slo.py): rolling evaluation window
    # and p95 latency targets for LLM TTFT and ingress request latency.
    slo_window_s: float = 300.0
    slo_ttft_p95_s: float = 2.0
    slo_request_p95_s: float = 5.0

    # --- metric time-series store (ray_tpu/obs_series.py; the GCS folds
    #     every metrics_push into per-key rings so the decision plane can
    #     reason over trends, not snapshots) ---
    # Per-series ring size: each (metric, tags, source) key keeps at most
    # this many points — store memory is fixed at max_series × points
    # regardless of run length.
    obs_series_points: int = 512
    # Points closer together than this coalesce (last write wins), so
    # retention ≈ points × resolution seconds (~8.5 min at defaults)
    # however fast sources flush.
    obs_series_resolution_s: float = 1.0
    # Hard cap on distinct series keys; past it, tombstoned series are
    # evicted first, then the one with the stalest newest point.
    obs_series_max_series: int = 4096
    # How long a tombstoned series (removed replica, expired source)
    # stays queryable for post-mortems before deletion.
    obs_series_tombstone_ttl_s: float = 120.0

    # --- serve shadow autoscaler (serve/autoscale.py) ---
    # off | shadow | enact. shadow (default) computes and publishes
    # replica-count recommendations (gauge + autoscale.recommend events +
    # /api/autoscale) without ever scaling; enact additionally applies
    # them through the existing reconcile drain/scale paths.
    serve_autoscale_mode: str = "shadow"
    # Evaluation cadence (each evaluation queries the series store).
    serve_autoscale_interval_s: float = 2.0
    # Rolling window the policy aggregates series over.
    serve_autoscale_window_s: float = 30.0
    # Per-replica (inflight + queued) the policy sizes capacity for
    # (deployment autoscaling_config target_ongoing_requests overrides).
    serve_autoscale_target_ongoing: float = 4.0
    # TTFT-p95 target in ms; 0 = derive from slo_ttft_p95_s.
    serve_autoscale_ttft_p95_ms: float = 0.0
    # slo_burn_rate{slo=llm_ttft_p95} above this reads as capacity-short
    # even when queue depth alone wouldn't scale up.
    serve_autoscale_burn_threshold: float = 1.0
    # Recommendation clamp (deployment autoscaling_config overrides).
    serve_autoscale_min_replicas: int = 1
    serve_autoscale_max_replicas: int = 8
    # Hysteresis: the raw desire must persist this long before the
    # recommendation moves (up fast, down slow)...
    serve_autoscale_up_sustain_s: float = 2.0
    serve_autoscale_down_sustain_s: float = 10.0
    # ...and after a move, further moves wait out a cooldown.
    serve_autoscale_up_cooldown_s: float = 5.0
    serve_autoscale_down_cooldown_s: float = 20.0
    # Enact-mode blast-radius guard: one enactment may change
    # num_replicas by at most this many replicas — one bad decision
    # window can't mass-kill (or mass-spawn) a fleet; convergence to a
    # far-away recommendation takes multiple cooldown-spaced steps.
    serve_autoscale_max_enact_step: int = 8

    # --- paths ---
    # Under the temp directory (TMPDIR when set), never a fixed path.
    session_dir: str = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    # Machine-persistent root for built pip runtime envs ("" = under the
    # session dir). Content-addressed digests make cross-session reuse safe.
    pip_env_cache_dir: str = ""

    def override(self, overrides: dict[str, Any] | None) -> "Config":
        if not overrides:
            return self
        unknown = set(overrides) - {f.name for f in dataclasses.fields(self)}
        if unknown:
            raise ValueError(f"unknown _system_config keys: {sorted(unknown)}")
        return dataclasses.replace(self, **overrides)

    @classmethod
    def from_env(cls) -> "Config":
        kw = {}
        for f in dataclasses.fields(cls):
            default = f.default
            kw[f.name] = _env(f.name, type(default), default)
        return cls(**kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls(**json.loads(s))


GLOBAL_CONFIG = Config.from_env()

# Raylets forward their full (possibly _system_config-overridden) Config to
# spawned workers through this env var, so driver-side overrides reach
# library code running inside workers — not just RAY_TPU_TORCH_* env vars.
CONFIG_ENV_JSON = "RAY_TPU_TORCH_CONFIG_JSON"


def current_config() -> Config:
    """Config for THIS process: the raylet-forwarded JSON in workers, the
    environment otherwise."""
    raw = os.environ.get(CONFIG_ENV_JSON)
    if raw:
        try:
            return Config.from_json(raw)
        except Exception as e:
            # A worker silently running on env defaults instead of the
            # raylet-forwarded config is a classic split-brain source.
            logger.warning("malformed %s (falling back to env): %s",
                           CONFIG_ENV_JSON, e)
    return Config.from_env()


def runtime_config() -> Config:
    """Best-effort config for library code that may run in any process:
    the attached client's config when one exists (drivers, actors), else
    `current_config()`. Never connects — reading a knob must not spawn a
    cluster as a side effect. Never raises."""
    try:
        from ray_tpu_torch import api as _api

        if _api._client is not None:
            return _api._client.config
    except Exception:  # graftlint: disable=EXC-SWALLOW (documented never-raises contract; falls back to process config)
        pass
    return current_config()
