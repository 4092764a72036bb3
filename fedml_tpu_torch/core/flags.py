"""Central registry for every ``cfg.extra`` feature flag + the one accessor.

The port's own copy of ``fedml_tpu/core/flags.py`` (stdlib only), so a
recipe that loads in the JAX package loads here with the same flags.  The
lint rule and ``docs/FLAGS.md`` named below belong to the JAX package.

``Config.extra`` is the escape hatch for recipe knobs that are not typed
dataclass fields — and before this registry it was read at ~40 sites with
two inconsistent idioms (``extra.get(...)`` on a local, inline
``(getattr(cfg, "extra", {}) or {}).get(...)``) and no inventory at all: a
typo'd recipe key silently fell back to its default, the main source of
silent cross-silo misconfiguration.  Now:

- every flag is declared ONCE here as a :class:`FlagSpec` (type, default,
  one-line doc);
- every read goes through :func:`cfg_extra`, which refuses undeclared names
  at runtime;
- the GL001 lint rule (``fedml_tpu/analysis/rules/gl001_flags.py``) enforces
  both directions statically: an undeclared read and a dead declaration are
  tier-1 failures;
- ``docs/FLAGS.md`` is generated from this registry
  (:func:`render_flag_reference`, ``python -m fedml_tpu.core.flags``).

``default=None`` with a ``derived:`` doc means the default is computed at
the call site (e.g. ``secagg_target_u`` defaults to ``t + 1``) — the caller
passes it explicitly to :func:`cfg_extra`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

__all__ = ["FlagSpec", "FLAGS", "cfg_extra", "cfg_extra_present",
           "set_cfg_extra", "render_flag_reference"]


@dataclass(frozen=True)
class FlagSpec:
    name: str
    type: str       # bool | int | float | str | dict | list
    default: Any    # None with a "derived:" doc = computed at the call site
    doc: str


_UNSET = object()


def _specs(*specs: FlagSpec) -> dict[str, FlagSpec]:
    out: dict[str, FlagSpec] = {}
    for s in specs:
        if s.name in out:
            raise ValueError(f"duplicate flag declaration {s.name!r}")
        out[s.name] = s
    return out


FLAGS: dict[str, FlagSpec] = _specs(
    # -- training / model ----------------------------------------------------
    FlagSpec("fused_blocks", "bool", False,
             "Route CIFAR-ResNet conv epilogues through the fused Pallas "
             "BasicBlock kernel (BN scale/shift + residual + ReLU in one pass)."),
    FlagSpec("mlp_hidden", "int", 128,
             "Hidden width of the synthetic `mlp` model (comm benches widen it "
             "past the compression block size)."),
    FlagSpec("silo_dp", "bool", True,
             "Intra-silo data parallelism over local devices when batch_size "
             "divides the local device count."),
    FlagSpec("unitedllm", "bool", False,
             "Cross-cloud runs exchange ONLY LoRA adapters (federated LLM "
             "training, UnitedLLM protocol)."),
    FlagSpec("lora_r", "int", None,
             "LoRA adapter rank; derived: surface default (8 FedLLM, 4 UnitedLLM)."),
    FlagSpec("lora_alpha", "float", 16.0, "LoRA scaling alpha."),
    FlagSpec("lora_targets", "list", None,
             "Module name substrings receiving LoRA adapters; derived: "
             "llm.lora.DEFAULT_TARGETS."),
    # -- simulator workloads -------------------------------------------------
    FlagSpec("seg_base", "int", 8, "UNet base channel width for FedSeg."),
    FlagSpec("gan_z_dim", "int", 64, "FedGAN generator latent dimension."),
    FlagSpec("decentralized_mode", "str", "dsgd",
             "Decentralized topology/algorithm: dsgd | pushsum | ring."),
    FlagSpec("topology_neighbor_num", "int", 2,
             "Neighbors per node in the decentralized mixing topology."),
    FlagSpec("ta_group_num", "int", 4, "TurboAggregate group count."),
    FlagSpec("ta_dropout_prob", "float", 0.0,
             "TurboAggregate simulated per-client dropout probability."),
    FlagSpec("group_assignment", "str", "balanced",
             "HierarchicalFL client-to-group assignment: balanced | random."),
    FlagSpec("vfl_party_num", "int", 2, "Vertical-FL party count."),
    FlagSpec("vfl_embed_dim", "int", 16, "Vertical-FL per-party embedding dim."),
    FlagSpec("nas_cells", "int", 2, "FedNAS DARTS cell count."),
    FlagSpec("nas_features", "int", 16, "FedNAS DARTS feature width."),
    FlagSpec("nas_arch_lr", "float", 3e-3, "FedNAS architecture learning rate."),
    FlagSpec("condshift_clusters", "int", 2,
             "Conditional-shift synthetic partitioner: label cluster count."),
    FlagSpec("condshift_scale", "float", 0.9,
             "Conditional-shift synthetic partitioner: shift strength."),
    # -- population-scale simulation (fedml_tpu/population/) -----------------
    FlagSpec("population_store", "str", None,
             "Root directory of the sharded client-state store; set -> the "
             "MeshSimulator streams per-round cohorts from disk shards "
             "instead of holding the full client stack in memory (unset = "
             "the in-memory path, bit-identical to before the flag existed)."),
    FlagSpec("population_size", "int", None,
             "Simulated population client count; derived: dataset.n_clients. "
             "Ids beyond the base dataset replicate its client shards "
             "cyclically."),
    FlagSpec("population_shard_size", "int", 4096,
             "Clients per store shard (one npz file of contiguous ids)."),
    FlagSpec("population_max_resident_shards", "int", 8,
             "Bounded LRU of in-memory shards — the knob that caps host RSS."),
    FlagSpec("population_shards_per_cohort", "int", None,
             "Shards the hierarchical sampler prefers per cohort; derived: "
             "ceil(2 * cohort / shard_size)."),
    FlagSpec("population_prefetch", "bool", True,
             "Double-buffered cohort prefetch: gather round k+1's data on a "
             "worker thread while round k computes."),
    # -- ahead-of-time program store (fedml_tpu/core/aot.py) -----------------
    FlagSpec("aot_programs", "bool", False,
             "Persist jax.export-serialized round/eval programs in the "
             "on-disk program store so warm restarts skip re-tracing (the "
             "remaining XLA compile rides the persistent compilation cache); "
             "unset = the plain jit path, bit-identical to before the flag "
             "existed."),
    FlagSpec("aot_programs_dir", "str", None,
             "Program-store directory; derived: "
             "<repo>/.jax_cache-<host>/aot_programs (core/cache.py's dir)."),
    # -- communication / transports ------------------------------------------
    FlagSpec("comm_compression", "str", None,
             "Upload codec for cross-silo model replies: qsgd8 | topk "
             "(unset = raw wire v1, byte-identical to the uncompressed protocol)."),
    FlagSpec("comm_topk_ratio", "float", None,
             "top-k codec keep ratio; derived: cfg.compression_ratio (0.01)."),
    FlagSpec("comm_compress_min_size", "int", 1024,
             "Minimum leaf element count before a float leaf is compressed "
             "(block padding would EXPAND smaller leaves)."),
    FlagSpec("streaming_aggregation", "bool", False,
             "Fold arriving client updates into a running weighted sum even "
             "without a codec (peak buffered updates <= 2)."),
    FlagSpec("server_shard_fold", "bool", False,
             "Place the server's streaming-fold accumulator (and the "
             "finalized global it produces) under parallel/mesh "
             "NamedShardings: each arriving leaf is device_put to its shard "
             "owners and folded there under jit instead of host-gathered — "
             "bitwise the host fold (unset = the host numpy fold, "
             "bit-identical to before the flag existed)."),
    FlagSpec("comm_chunk_bytes", "int", 0,
             "Split gRPC/TCP/in-proc sends larger than this into bounded "
             "chunk frames that interleave at the socket level — BOTH legs: "
             "client uploads and the server->client model broadcast "
             "(receivers reassemble + decode incrementally per peer); 0 = "
             "one frame per message, byte-identical to the unchunked "
             "protocol."),
    FlagSpec("comm_chunk_idle_sweep_s", "float", 120.0,
             "Idle timeout for a partially assembled chunk stream: a sender "
             "that dies mid-upload has its stream evicted (a metered, "
             "sender-attributed drop) after this long without a new chunk."),
    # -- deterministic chaos injection (fedml_tpu/comm/chaos.py) --------------
    FlagSpec("chaos_seed", "int", 0,
             "Seed of the deterministic per-peer fault schedule; the same "
             "seed over the same message sequence reproduces the same "
             "faults exactly."),
    FlagSpec("chaos_drop_prob", "float", 0.0,
             "Per-send probability a message silently vanishes on the wire."),
    FlagSpec("chaos_delay_prob", "float", 0.0,
             "Per-send probability a message is delivered late (uniform in "
             "(0, chaos_delay_max_s])."),
    FlagSpec("chaos_delay_max_s", "float", 0.05,
             "Upper bound of an injected delivery delay."),
    FlagSpec("chaos_duplicate_prob", "float", 0.0,
             "Per-send probability a message is delivered twice (at-least-"
             "once transport redelivery)."),
    FlagSpec("chaos_reorder_prob", "float", 0.0,
             "Per-send probability a message is held back and delivered "
             "AFTER the next message to the same peer."),
    FlagSpec("chaos_corrupt_prob", "float", 0.0,
             "Per-send probability the encoded frame ships with flipped "
             "bytes (must die in the receive loop's drop path, never in a "
             "handler)."),
    FlagSpec("chaos_reset_prob", "float", 0.0,
             "Per-send probability the transport raises ConnectionResetError "
             "instead of sending (the peer-gone failure senders must survive)."),
    FlagSpec("chaos_partition", "str", None,
             "Timed network partition as 'start_s:duration_s' after comm-"
             "manager start: every send inside the window fails with "
             "ConnectionResetError (unset = no partition)."),
    FlagSpec("grpc_base_port", "int", 8890, "gRPC backend rank-0 port."),
    FlagSpec("grpc_ip_config", "dict", None,
             "gRPC backend rank -> host mapping (unset = localhost)."),
    FlagSpec("tcp_base_port", "int", 9690, "TCP backend rank-0 port."),
    FlagSpec("tcp_ip_config", "dict", None,
             "TCP backend rank -> host mapping (unset = localhost)."),
    FlagSpec("mqtt_host", "str", None,
             "Real MQTT broker host for the MQTT_S3 backend (unset = in-proc "
             "loopback broker)."),
    FlagSpec("mqtt_port", "int", 1883, "Real MQTT broker port."),
    FlagSpec("object_store_url", "str", None,
             "HTTP object store for >8KB MQTT payloads (required with mqtt_host)."),
    # -- cross-silo / cross-device server ------------------------------------
    FlagSpec("async_aggregation", "bool", False,
             "Buffered-async (FedBuff-style) cross-silo server: clients "
             "upload whenever local training finishes, arrivals fold into "
             "the streaming accumulator with staleness-decayed weights, and "
             "a virtual round closes every async_buffer_k arrivals (unset = "
             "the synchronous round server, bit-identical to before the "
             "flag existed)."),
    FlagSpec("async_buffer_k", "int", 8,
             "Arrivals folded per virtual round on the buffered-async "
             "server (FedBuff's K)."),
    FlagSpec("async_staleness_exponent", "float", 0.5,
             "Polynomial staleness decay s(tau) = (1 + tau)^-alpha applied "
             "to each async arrival's weight; 0 disables the decay."),
    FlagSpec("async_concurrency", "int", None,
             "Clients kept training concurrently by the async server; "
             "derived: client_num_per_round."),
    FlagSpec("async_redispatch_timeout_s", "float", 30.0,
             "Async dispatch deadline: an upload not back within this many "
             "seconds counts a health breach and the work is re-issued to "
             "another client; 0 disables the watchdog."),
    FlagSpec("server_journal_dir", "str", None,
             "Durable server recovery journal directory: the cross-silo "
             "servers (sync + buffered-async) atomically snapshot their full "
             "protocol state at round boundaries and recover from it on "
             "restart with a bumped session epoch (unset = no journal, "
             "wire + aggregation bit-identical to before the flag existed)."),
    FlagSpec("server_journal_keep", "int", 3,
             "Journal snapshots retained on disk (older steps are pruned; "
             "the newest intact step is never pruned)."),
    FlagSpec("server_journal_every_rounds", "int", 1,
             "Snapshot cadence in (virtual) rounds; the final round is "
             "always journaled."),
    FlagSpec("server_journal_every_folds", "int", 0,
             "MID-ROUND snapshot cadence on the synchronous server: with the "
             "streaming fold engaged, journal the partial accumulator every "
             "N folds so a crash between folds resumes the round's partial "
             "sum instead of redoing it (0 = round-boundary snapshots only; "
             "requires server_journal_dir)."),
    FlagSpec("client_journal_dir", "str", None,
             "Durable CLIENT recovery journal root: each cross-silo client "
             "atomically snapshots its protocol state (error-feedback "
             "residuals, last-received version + session epoch, upload "
             "idempotence attempts, optional trainer local state) before "
             "every upload and resumes mid-conversation from it on restart; "
             "uploads carry an idempotence key the servers dedup on (unset "
             "= no journal, no key header, wire byte-identical to before "
             "the flag existed)."),
    FlagSpec("client_journal_keep", "int", 2,
             "Client-journal snapshots retained per client (older steps are "
             "pruned)."),
    FlagSpec("client_journal_keep_retired", "int", 8,
             "Per-rank journal directories of RETIRED clients (ranks no "
             "longer in the live set) kept under client_journal_dir; older "
             "retired dirs are reclaimed at run finish — live ranks are "
             "never pruned."),
    # -- hierarchical aggregation tree (cross_silo/edge.py) -------------------
    FlagSpec("hier_fanout", "int", 0,
             "Children per aggregator in the hierarchical aggregation tree: "
             "set > 0 to route client uploads through ceil(N/fanout) edge "
             "aggregators that fold their children's arrivals and ship ONE "
             "pre-folded weighted partial to the root (0 = flat protocol, "
             "byte-identical to before the flag existed)."),
    FlagSpec("hier_depth", "int", 2,
             "Aggregation tree depth when hier_fanout is set: 2 = client -> "
             "edge -> root; 3 adds a region tier between edges and root."),
    FlagSpec("hier_topology", "dict", None,
             "Explicit aggregation tree: {'edges': [[client_rank, ...], ...]"
             ", 'regions': [[edge_ordinal, ...], ...]} — overrides the "
             "hier_fanout round-robin construction (regions optional; every "
             "client rank must appear in exactly one edge)."),
    FlagSpec("hier_hop_codec", "str", None,
             "Per-hop re-encode of the edge->parent partial: qsgd8 | topk "
             "(unset = the raw f32 partial, which keeps the tree fold "
             "bitwise equal to the flat streaming fold)."),
    FlagSpec("straggler_timeout_s", "float", 0.0,
             "Bounded-wait straggler deadline per round; 0 = wait forever."),
    FlagSpec("straggler_quorum_frac", "float", 0.5,
             "Fraction of selected clients that must arrive before a "
             "straggler-timeout round proceeds."),
    FlagSpec("health_aware_selection", "bool", False,
             "client_selection deprioritizes degraded ranks using the "
             "per-client health ledger."),
    FlagSpec("device_max_missed_rounds", "int", 2,
             "Cross-device liveness: rounds a device may miss before "
             "exclusion from candidate selection."),
    FlagSpec("cross_device_timeout_s", "float", 600.0,
             "Cross-device server run deadline."),
    # -- secure aggregation / crypto -----------------------------------------
    FlagSpec("secagg_method", "str", "lightsecagg",
             "Secure-aggregation protocol: lightsecagg | shamir."),
    FlagSpec("secagg_privacy_t", "int", None,
             "Secret-sharing privacy threshold; derived: max(1, n_clients // 2)."),
    FlagSpec("secagg_target_u", "int", None,
             "LightSecAgg surviving-client target; derived: privacy_t + 1."),
    FlagSpec("secagg_q_bits", "int", 16, "Secure-aggregation quantization bits."),
    FlagSpec("secagg_stream", "bool", False,
             "Streaming secure aggregation: masked uploads fold "
             "one at a time into a running field total (peak buffered <= 2 "
             "at any cohort size) and ship on the minimal ring dtype "
             "(dense+mask u32 instead of int64; qsgd8+mask at int8 width + "
             "cohort carry bits); dropout masks reconstructed and "
             "subtracted once at finalize.  Unset = the historical "
             "buffer-all protocol, wire byte-identical."),
    FlagSpec("secagg_q8_frac_bits", "int", 7,
             "Fractional bits of the quantize-then-mask int8 grid "
             "(comm_compression=qsgd8 under secagg_stream): deltas quantize "
             "to round(x * 2^bits) stochastically, clipped to [-127, 127]. "
             "A CONFIG-SHARED scale — per-block adaptive qsgd8 scales "
             "cannot decode a masked sum."),
    FlagSpec("fhe_key_seed", "int", None,
             "RLWE key seed (out-of-band in production); derived: "
             "random_seed * 7919 + 17."),
    FlagSpec("fhe_ring_dim", "int", 1024, "RLWE ring dimension."),
    FlagSpec("fhe_frac_bits", "int", 16, "FHE fixed-point fractional bits."),
    # -- trust: attacks / defenses -------------------------------------------
    FlagSpec("attack_boost", "float", 10.0, "Model-replacement attack boost."),
    FlagSpec("attack_original_class", "int", 0, "Backdoor source class."),
    FlagSpec("attack_target_class", "int", 1, "Backdoor target class."),
    FlagSpec("attack_poison_frac", "float", 0.5,
             "Fraction of an attacker's shard that is poisoned."),
    FlagSpec("edge_case_type", "str", "southwest",
             "Edge-case backdoor variant (reference attack zoo name)."),
    FlagSpec("soteria_percentile", "float", 1.0,
             "Soteria defense: percentile of elements perturbed."),
    FlagSpec("wbc_pert_strength", "float", 1.0, "WBC defense perturbation strength."),
    FlagSpec("wbc_lr", "float", 0.1, "WBC defense inner learning rate."),
    # -- observability -------------------------------------------------------
    FlagSpec("metrics_port", "int", None,
             "Serve /metrics + /healthz on this port (unset = no server)."),
    FlagSpec("otlp_endpoint", "str", None,
             "OTLP/HTTP collector base URL; unset = no exporter object, no "
             "worker thread ($FEDML_TPU_OTLP_ENDPOINT overrides)."),
    FlagSpec("enable_remote_obs", "bool", False,
             "Clients ship telemetry batches to the server's ObsCollector "
             "over the FL transport."),
    FlagSpec("obs_jsonl_path", "str", None,
             "Server-side collector JSONL trail path (obs report input)."),
    FlagSpec("otlp_protocol", "str", "json",
             "OTLP/HTTP encoding: json (proto3-JSON, the default), protobuf "
             "(stdlib binary proto writer), or auto (start JSON, fall back "
             "to protobuf for the rest of the run when the collector "
             "rejects the JSON body with 415/400)."),
    FlagSpec("flight_recorder", "bool", False,
             "Per-process flight recorder: a bounded ring of recent spans, "
             "metric deltas, comm/chaos events, and journal/epoch "
             "transitions that dumps an atomic black-box bundle on trigger "
             "(unhandled exception, SIGTERM, SLO breach, accounting "
             "violation, hard kill, finish); unset = no ring, no taps, no "
             "bundles — the default path is bit-identical to before the "
             "flag existed."),
    FlagSpec("flight_dir", "str", None,
             "Directory black-box bundles are dumped into; derived: "
             "<cwd>/flight_bundles."),
    FlagSpec("flight_capacity", "int", 4096,
             "Flight-recorder ring capacity in events (oldest evicted "
             "first — the bound that keeps black-box memory constant under "
             "sustained load)."),
    FlagSpec("flight_window_s", "float", 60.0,
             "Seconds of ring history a bundle includes (0 = everything "
             "still in the ring)."),
    FlagSpec("slo_specs", "dict", None,
             "Declarative SLO specs evaluated on registry snapshots via the "
             "server runtime's timer wheel: {name: {metric, stat, op, "
             "threshold[, per][, labels]}} — stat is value|sum|count|rate|"
             "mean|pNN; breaches land in the collector trail, OTLP, and "
             "fedml_slo_breaches_total{slo} (unset = no engine, no timer)."),
    FlagSpec("slo_interval_s", "float", 1.0,
             "SLO evaluation cadence on the timer wheel."),
    FlagSpec("slo_flight_dump", "bool", False,
             "An SLO breach additionally triggers a flight-recorder bundle "
             "dump (once per SLO, requires flight_recorder)."),
    FlagSpec("cost_model_gauges", "bool", False,
             "Run XLA cost_analysis() on AOT-store programs at build/load "
             "and export fedml_program_flops / "
             "fedml_program_bytes_accessed gauges per program, plus the "
             "derived per-round achieved-FLOPS/MFU gauges in sim/engine.py "
             "(forces an eager compile at program resolve time; unset = no "
             "cost analysis, bit-identical default path)."),
    FlagSpec("perf_timeline", "bool", False,
             "Continuous performance timeline: periodic registry-snapshot "
             "deltas sampled on the server runtime's timer wheel into a "
             "bounded in-memory ring plus atomic on-disk segment files, "
             "with range-scan / windowed-rate / histogram-pNN queries and a "
             "convergence series tee'd from the servers' round history "
             "(fedml_convergence_rounds_to_target); unset = no recorder, "
             "no timer, bit-identical default path."),
    FlagSpec("timeline_dir", "str", None,
             "Directory timeline segment files are flushed into; derived: "
             "<cwd>/perf_timeline."),
    FlagSpec("timeline_interval_s", "float", 1.0,
             "Timeline sampling cadence on the timer wheel."),
    FlagSpec("timeline_capacity", "int", 512,
             "Timeline ring capacity in samples (oldest evicted first — "
             "the bound that keeps recorder memory constant under "
             "sustained sampling); segments flush every capacity/2 "
             "samples."),
    FlagSpec("profile_rounds", "str", None,
             "Profile window for per-program device-time attribution: 'n' "
             "traces rounds 0..n-1, 'k:n' traces n rounds starting at k "
             "(programmatic jax.profiler start/stop around the sim "
             "engine's round chunks; unset = no tracing, bit-identical "
             "default path)."),
    FlagSpec("profile_dir", "str", None,
             "Directory the profiler trace + attribution JSON land in; "
             "derived: <cwd>/profile_traces."),
    # -- multi-host ----------------------------------------------------------
    FlagSpec("coordinator_address", "str", None,
             "jax.distributed coordinator host:port "
             "($JAX_COORDINATOR_ADDRESS fallback)."),
    FlagSpec("num_processes", "int", None,
             "jax.distributed process count ($JAX_NUM_PROCESSES fallback)."),
    FlagSpec("process_id", "int", None,
             "jax.distributed process id ($JAX_PROCESS_ID fallback)."),
    # -- multi-tenant control plane (fedml_tpu/sched/multi_tenant.py) ---------
    FlagSpec("mt_job_id", "str", None,
             "Tenant job id under a multi-tenant control plane: namespaces "
             "the job's run_id, journal roots (<journal_root>/job_<id>/), "
             "and metric label (job=<id>); unset = single-job run, every "
             "path bit-identical to before the flag existed."),
    FlagSpec("mt_weight", "float", 1.0,
             "Fair-share weight of this tenant's job: the gang scheduler "
             "charges each granted round's measured wall time / weight to "
             "the job's virtual clock, so a weight-2 job receives ~2x the "
             "mesh time of a weight-1 sibling."),
    FlagSpec("mt_priority", "int", 0,
             "Strict priority class of this tenant's job: higher classes "
             "win every round-boundary grant over lower ones (preemption "
             "is at round boundaries only — a running round is never "
             "aborted); fair share applies within a class."),
    FlagSpec("mt_slots", "int", 1,
             "Concurrent mesh slots the multi-tenant gang scheduler grants: "
             "how many tenants' (virtual) rounds may run on the shared "
             "mesh/host pool at once."),
    FlagSpec("mt_shared_aot_dir", "str", None,
             "Shared AOT program-store root for all tenants of one control "
             "plane: jobs with the same tracing fingerprint deserialize "
             "each other's exported round/eval programs instead of "
             "recompiling (unset = per-config aot_programs_dir semantics)."),
    FlagSpec("mt_submesh_shape", "str", None,
             "Per-job submesh shape ('clients:2' / 'silo:1,data:2') the "
             "control plane carves out of the fleet's device array: each "
             "admitted job leases a DISJOINT contiguous submesh and its "
             "rounds run genuinely concurrently with its siblings' instead "
             "of time-slicing the full mesh; unset (or shapes that do not "
             "tile the fleet — see mt_submesh_jobs) = PR-14 time-sliced "
             "gate semantics, bit-identical."),
    FlagSpec("mt_submesh_jobs", "int", None,
             "Number of disjoint submeshes to carve (the fleet partition "
             "degree): mt_submesh_shape x mt_submesh_jobs device totals "
             "must fit in the fleet or the plan is rejected and the "
             "scheduler falls back to the time-sliced gate; derived: "
             "fleet size // submesh size."),
    FlagSpec("mt_quota_burst", "float", 0.0,
             "Token-bucket admission quota per tenant, in grants: a job "
             "spends one token per granted round and the bucket refills at "
             "1/mt_quota_refill_s tokens per second up to this burst cap, "
             "so one tenant cannot starve the fleet between round "
             "boundaries no matter its weight; 0 = quota disabled "
             "(fair-share only, bit-identical to before the flag existed)."),
    FlagSpec("mt_quota_refill_s", "float", 1.0,
             "Seconds to refill ONE admission token of the mt_quota_burst "
             "bucket (the steady-state grant period a quota-capped tenant "
             "converges to)."),
    # -- serving -------------------------------------------------------------
    FlagSpec("model_publish_dir", "str", None,
             "Continuous model publication directory: the cross-silo servers "
             "(sync + buffered-async) atomically write a version-stamped "
             "params file + MANIFEST.json at every (virtual-)round version "
             "bump so serving workers can hot-swap the live model (unset = "
             "no publish writes, serving-free runs bit-identical to before "
             "the flag existed)."),
    FlagSpec("model_publish_keep", "int", 5,
             "Published param-file versions retained on disk (older versions "
             "are pruned; the manifest-referenced file is never pruned)."),
    FlagSpec("end_point_name", "str", None,
             "Serving endpoint name; derived: 'ep-<run_id>'."),
    FlagSpec("serving_model_name", "str", None,
             "Model card name for deploy; derived: cfg.model."),
    FlagSpec("model_version", "str", "v1", "Model card version for deploy."),
    FlagSpec("gateway_port", "int", 0,
             "Tenant-routed serving gateway listen port (0 = ephemeral): "
             "one HTTP front door for a shared worker fleet, routing each "
             "request's tenant id to the worker bound to that tenant's "
             "model_publish_dir."),
    FlagSpec("gateway_max_batch", "int", 8,
             "Gateway-side coalescing batch cap per tenant: requests for "
             "the same tenant are batched at the gateway before the "
             "worker's own micro-batcher sees them."),
    FlagSpec("gateway_flush_ms", "float", 2.0,
             "Gateway batching window per tenant in milliseconds — how "
             "long an under-filled tenant batch waits for co-tenants' "
             "rows before flushing to the worker."),
)


def cfg_extra(cfg, name: str, default: Any = _UNSET) -> Any:
    """Read the declared flag ``name`` from ``cfg``.

    Resolution order matches the historical duck-typed behavior: a direct
    attribute on ``cfg`` wins (tests ``setattr`` flags straight onto Config,
    and ``Config.__getattr__`` itself falls through to ``extra``), then the
    ``cfg.extra`` dict, then ``default`` (the registry default when the call
    site passes none).  ``cfg=None`` short-circuits to the default — several
    constructors accept an optional config.

    Raises ``KeyError`` for names missing from :data:`FLAGS`: an undeclared
    flag read is a bug here exactly like it is in GL001.
    """
    spec = FLAGS.get(name)
    if spec is None:
        raise KeyError(
            f"undeclared extra flag {name!r} — declare it in fedml_tpu_torch/core/flags.py")
    fallback = spec.default if default is _UNSET else default
    if cfg is None:
        return fallback
    value = getattr(cfg, name, _UNSET)
    if value is _UNSET:
        extra = getattr(cfg, "extra", None) or {}
        value = extra.get(name, _UNSET)  # graftlint: disable=GL001(the accessor itself)
    return fallback if value is _UNSET else value


def cfg_extra_present(cfg, name: str) -> bool:
    """Registry-checked membership: is the declared flag ``name`` explicitly
    SET on ``cfg``?  The value-resolution twin of :func:`cfg_extra` for the
    ``"name" in cfg.extra`` idiom — it follows the same resolution order (a
    direct attribute counts as set, then the ``extra`` dict), and unlike
    ``cfg_extra`` it keeps present-but-``None`` distinct from absent.

    Raises ``KeyError`` for undeclared names, exactly like :func:`cfg_extra`.
    """
    if name not in FLAGS:
        raise KeyError(
            f"undeclared extra flag {name!r} — declare it in fedml_tpu_torch/core/flags.py")
    if cfg is None:
        return False
    if getattr(cfg, name, _UNSET) is not _UNSET:
        return True
    extra = getattr(cfg, "extra", None) or {}
    return name in extra  # graftlint: disable=GL001(the membership accessor itself)


def set_cfg_extra(cfg, name: str, value: Any) -> Any:
    """Registry-checked WRITE of the declared flag ``name`` into
    ``cfg.extra`` (the one blessed mutation idiom — harness code seeding a
    flag for downstream readers).  Returns ``value`` so assignments can
    chain.  Raises ``KeyError`` for undeclared names."""
    if name not in FLAGS:
        raise KeyError(
            f"undeclared extra flag {name!r} — declare it in fedml_tpu_torch/core/flags.py")
    extra = getattr(cfg, "extra", None)
    if extra is None:
        extra = {}
        cfg.extra = extra
    extra[name] = value
    return value


def render_flag_reference() -> str:
    """The generated flag-reference markdown (checked in as ``docs/FLAGS.md``)."""
    lines = [
        "# `cfg.extra` flag reference",
        "",
        "Generated from `fedml_tpu/core/flags.py` — regenerate with",
        "`python -m fedml_tpu.core.flags > docs/FLAGS.md` after editing the",
        "registry.  Every flag is read through `cfg_extra(cfg, name, default)`;",
        "the GL001 lint rule fails tier-1 on undeclared reads and dead",
        "declarations, so this table is complete by construction.",
        "",
        "| Flag | Type | Default | Description |",
        "|---|---|---|---|",
    ]
    for name in sorted(FLAGS):
        s = FLAGS[name]
        default = "`None`" if s.default is None else f"`{s.default!r}`"
        doc = s.doc.replace("|", "\\|")  # keep literal pipes out of the table grid
        lines.append(f"| `{name}` | {s.type} | {default} | {doc} |")
    lines.append("")
    return "\n".join(lines)


if __name__ == "__main__":
    print(render_flag_reference(), end="")
