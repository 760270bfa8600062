#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--steps N]

Drives the port's main paths once each, through their entry points,
at the full width of ``openai-community/gpt2`` (12 layers, 768 wide, 50257
vocab; ~124 M f32 parameters, random weights from ``--seed``):

1. build the CUDA kernels from ``zest_tpu_torch/csrc/blake3.cu`` (the
   BLAKE3 chunk kernel and the fused regroup → BLAKE3 kernel) and
   ``csrc/bg4.cu`` (the standalone regroup; one nvcc each, side by side)
   and the native host library from ``zest_tpu_torch/native/*.cc``, and
   count the SASS instructions of one BLAKE3 compression (a probe kernel
   around the source's ``compress``, read with ``cuobjdump``): the
   operation bounds count them;
2. hold the BLAKE3 kernel bit-exact against its plain PyTorch version and
   the native host BLAKE3 on the card (plain and keyed, with garbage past
   each row's length), at every leaf count 1–128 and each 32-leaf group
   edge;
   2b. hold the BG4 regroup kernel and the fused kernel bit-exact against
   their plain versions and the native host decode + BLAKE3, at every
   chunk length mod 4, every leaf count 1–128 and each group edge, plain
   and keyed, with garbage in every planar slot past its plane;
3. ``push_checkpoint`` into node A's cache — every minted chunk is
   re-verified by the BLAKE3 kernel;
4. ``pull_model(device="cuda", no_p2p=True)`` into a fresh node B
   through node A's loopback publisher endpoint. With no swarm the warm
   fetch streams each unit's CDN body into its cache file (the stream
   tier): the cache holds no short or temp entry, its bytes are the CDN
   bytes, the files' lanes the tensors' and config.json's. It lands
   directly: tensors decode from
   the xorb cache into a pinned ring and commit to ``cuda:0`` in layer
   order, embedding and layer 0 first, and the HF-cache files are written
   from the same ring slots. Gates: one copy of the xorbs from the CDN
   (no whole-file fallback), ``hbm.direct`` and ``hbm.streamed``,
   ``0 < time_to_first_layer_s < time_to_hbm_s``, the ring within its
   budget (or the oversized-alone bound), file bytes from the ``tensors``
   lane, the files equal to the pushed ones and the landed tree on
   ``cuda:0`` with the CPU landing's digest;
   4b. the same tensors as a three-shard HF checkpoint (split in layer
   order at 200 MB, as ``save_pretrained(max_shard_size="200MB")`` lays
   it out, with ``model.safetensors.index.json``), pushed as a second repo
   and pulled into a fresh node with a 64 MiB, 4-slot ring: phase 4's
   gates and digest, ring slots reused, every shard warmed;
   4c. phase 4's repo pulled again into node B: every file is complete,
   so the landing stages from disk (``hbm.direct`` false), with phase 4's
   digest;
5. greedy KV-cached decoding at batch 1 and 4 from the landed tree, equal
   to the port's own CPU float32 run;
   5b. the revision hot-swap: node B, holding phase 4's tree on ``cuda:0``,
   subscribes to node A's publisher (``watch_and_swap``); node A pushes
   revision B (A with the last block's MLP weights and the final norm
   redrawn from ``--seed + 1``) with ``notify=True``, and the subscriber
   delta-pulls B over A's tree. Gates: the push's BLAKE3 kernel rows equal
   its minted chunks; the record names B; ``delta_bytes_ratio`` < 0.1 and
   ``0 < fetched_bytes <= changed + stale bytes``; every tensor reused or
   landed (148), the redrawn ones among at most 12 landed, every reused one
   at A's ``data_ptr``; the base dict empty; the peak allocation above its
   level before the pull at most the landed bytes plus one commit group;
   the tree with the digest of B's CPU landing; B's files exact, from the
   cache lane; greedy decode at batch 1 and 4 equal to the CPU's;
6. the cooperative pull: ``COOP_HOSTS`` (4) fresh hosts in threads, each
   with its own cache and DCN server on loopback, run
   ``pull_model(coop=True)`` of revision A (by its sha: phase 5b moved
   ``main`` to B) against node A's publisher, with the point-to-point
   exchange (``coop_collective=False``). Each fetches its
   share from the CDN and receives the rest over DCN, every received whole
   xorb verified on the card (BG4 chunks through the fused kernel); no
   fallbacks, no rejections, ≥ 60% peer-served, one copy of the xorbs from
   the CDN in all, every host landing directly, the files and landed
   digests equal to phase 4's, the
   fused kernel's rows equal to the BG4 chunks the hosts received and no
   standalone regroup launch; then each host's receipt verification is
   timed again without the network, once alone and once with every
   host's verifier running at the same time. Phase 6 runs traced (a
   tracer installed around the four pulls, each host's thread and DCN
   server stamping its host index): each host's ``stats["critical_path"]``
   covers ≥ 90% of its ``time_to_hbm_s`` with its stages summing to the
   path within 1 ms; the trace split by host and merged
   (``telemetry.fleet``) has four host tracks, one trace id and
   client→server flow links, each host's spans covering ≥ 90% of its
   ``coop.round``; the fused kernel launched once per received xorb with
   BG4 chunks, as untraced; each host's stage split and idle time are
   printed;
   6c. four fresh hosts the same way with the collective exchange (the
   default ``dcn`` backend): phase 6's gates, and a ``collective`` block
   on every host, a hypercube in 2 phases, not aborted;
   6d. again with ``collective_backend="jax"`` (the device lane) and
   ``coop_topology=(0, 0, 1, 1)``: a hierarchical schedule in 2 phases,
   intra-slice windows through lanes on ``cuda:0`` (``ici_windows`` > 0)
   and both ici and dcn bytes > 0, with phase 6c's other gates;
20. (run after 6d) the collective over a pod map: four fresh hosts the
   same way with ``coop_topology=WAN_SLICES`` (each host its own slice)
   and ``coop_pods=WAN_PODS`` (two pods of two), each host's
   ``DcnServer`` given both maps, its host index and ``WAN_SHAPING`` (a
   cross-slice link 200 MB/s and 5 ms a request window, a cross-pod one
   50 MB/s and 20 ms): phase 6's gates (the trees' digest phase 4's, the
   fused kernel's rows the BG4 chunks received and kernel #1's the
   rest), the federated schedule in 2 phases on every host, unaborted;
   every host's ``link_bytes`` equal to the bytes its schedule requests
   over each class, from the plan on the CPU (what the round moves
   unshaped), DCN bytes on every host and WAN bytes on the gateways
   (hosts 0 and 2) only; each class's phase walls at least its bytes over
   its rate less one burst of the serving bucket a phase;
10. (run after 6d) the pod round: a fresh node runs ``pod_round`` of
   revision A over ``pod_mesh(["cuda:0"] * 4)`` into a
   ``TieredCache(HbmStagingCache(cuda:0), disk)`` under a 256 MiB budget:
   every unit filled, none rejected, ≥ 2 waves, the peak pool within the
   budget or the single-unit bound, the BLAKE3 and fused kernels' rows
   equal to the units' chunks; then a default ``pull_model(device="cuda")``
   reports ``stats["pod"]["skipped"]`` (one card) and lands with 0 CDN
   bytes, files and digest equal to phase 4's; a second fresh node's round
   with one owned unit corrupted in flight rejects it (``verify_rejected``
   1) and the next pull heals it with exactly that unit's CDN bytes;
   ``all_gather_throughput`` over the four slots is printed;
7. ``meta-llama/Llama-3.2-1B`` at its published width and depth
   (``LLAMA_CONFIG``: 1,235,814,400 parameters, 146 bf16 tensors, one
   2,471,628,800-byte ``model.safetensors``, tied embeddings, llama3 rope
   scaling; random weights from ``--seed + 7``): pushed to node A (the
   BLAKE3 kernel's rows equal the minted chunks), pulled onto ``cuda:0``
   by the direct streaming landing (phase 4's gates, files and digest
   exact, the tree bf16), then ``load_generator(tensors=...)`` decodes an
   8-token prompt plus ``--steps`` at batch 1 and 4. Gates: the cached
   path's logits at every position within ``LOGITS_TOL`` of the CPU's
   uncached float32 forward (TF32 off; the error with TF32 on and with
   the tree in bf16 printed beside it, the bf16 one beyond the tolerance);
   greedy tokens, and sampled ones (``SAMPLING``, Gumbel noise drawn once
   on the host and injected on both sides), equal to the CPU float32
   run's, unless the CPU run's top-2 margin where a row first differs is
   below the tolerance; one seed twice on the card gives one draw;
   ``on_token`` sees each generated position once, in order. The pull
   runs traced with ``slo_tthbm_s`` armed at 1 µs: its critical path
   covers ≥ 90% of ``time_to_hbm_s`` and its stages sum to it within 1 ms,
   ``analyze --json`` over the exported trace gives every stage within
   1 ms, and the ``slo_breach`` event blames the path's largest stage; the
   traced ``time_to_hbm_s`` is printed beside the untraced spread. The
   pull has no swarm: its trace holds one ``cdn.stream`` span per unit
   the warm fetch streamed, their bytes the warm fetch's, and its CDN
   bytes are theirs and the header prefetch's terms';
8. the swarm peer tier, revision A by its sha (phase 4's repo, every
   tensor at full width and depth): node B, which holds A's xorbs from
   phase 4, seeds its cache as its own process (``python -m
   zest_tpu_torch serve --listen-port P --dcn-port 0 --port 0``: a
   ``BtServer`` and a ``DcnServer`` beside the publisher), and a fresh
   node pulls onto ``cuda:0`` with B as its direct peer.
   8a. a clean seeder. Gates: ``p2p_ratio`` ≥ 0.9 and CDN bytes at most
   10% of one copy of the xorbs; phase 4's landing gates (direct,
   streamed); files and digest equal to phase 4's; no peer failure, no
   corruption, no quarantine; the seeder served chunks; no kernel launch
   on the path (the peer tier verifies on the host, as the JAX package's
   does);
   8b. the seeder restarted with ``ZEST_FAULTS=upload_corrupt:1.0``: every
   upload is corrupt, and a fresh node pulls the same way. Gates: files
   and digest still phase 4's; ``fetch.resilience.corrupt_from_peer`` ≥ 1;
   the seeder quarantined; CDN bytes at most 1.05 × one copy; every
   whole-xorb cache entry of the node hashes back to its key (no corrupt
   blob under a full key);
15. (run after 8) peer discovery, revision A by its sha: node B's cache
   seeded again by its own ``serve`` process, now with a coop identity
   (host 0 of 2: a gossip node on its swarm and its DCN listener) and
   ``--tracker`` pointing at a loopback BitTorrent HTTP tracker that
   this script runs (``LoopbackTracker``). No step names B as a direct
   peer; each landing's only peer source is the sub-phase's one, and it
   holds 8a's gates plus ``swarm.peers_discovered`` > 0 and no direct
   peer. 15a: ``python -m zest_tpu_torch seed --tracker URL`` over B's
   cache prints ``announced N/N`` and the tracker holds every cached
   xorb at B's port; a fresh node lands with ``cli._build_swarm(cfg,
   tracker=URL, dht=False)``, the tracker sees its lookups, and after
   ``POST /v1/push`` of A's xorbs to B, B's own announces carry
   ``uploaded`` > 0 (the ``zest_seed_bytes_total`` it served). 15b: three
   loopback ``Dht`` nodes: a router, the seeder's node announcing B's
   xorbs at B's port through ``SwarmDownloader.announce_xorbs`` and the
   leecher's, both bootstrapped from the router; the leecher's node is
   the fresh node's only source. 15c: the push put A's xorbs in B's
   gossip digest; the leecher's ``GossipNode`` (host 1), over
   ``DcnGossipTransport`` to B's DCN port, names host 0 as holder of
   every xorb of A within 2 ticks and is its swarm's only source (its
   ``gossip`` block shows the rounds). 15d: a fresh node's files-only
   pull (``land=False``) with 15a's swarm: every xet file written by the
   ``ParallelDownloader`` rung over the shared term pool (each rung's
   writes counted), files byte-identical, ``lane_bytes`` all
   ``waterfall`` (the xet files and config.json), no fallback. No kernel
   launches on any of the four paths;
9. the serving daemon, its Llama trees at Llama-3.2-1B's published
   width with the **depth cut 16 → ``POOL_LAYERS`` (2)**. 9r: that
   checkpoint (random bf16 from ``--seed + 7``, 768,626,688 B) pushed to
   node A as ``POOL_REPO`` (kernel rows = minted chunks), landed onto
   the card into node ``l2`` with phase 4's gates, its float32 logits
   along the card's greedy and sampled tokens within ``LOGITS_TOL`` of
   the CPU's forward at every position (the bf16 error beyond the
   tolerance; the CPU decodes stay phase 7's). 9a: an
   ``HbmPool`` on ``cuda:0`` in this process over fresh node pulls. The
   2-layer Llama from 9r's snapshot: a cold generate decodes from the
   first-layer commit, before the landing ends; the pool's digest equals
   9r's landing; greedy and injected-noise sampled tokens (bf16, batch 1
   and 4) equal 9r's float32 card tokens, unless the float32 decision's
   margin where a row first differs is below twice 9r's bf16 logits
   error; an evict gives back at least the tree's bytes of
   ``memory_allocated``; a re-land has the same digest and bit-equal
   tokens.
   ``mistralai/Mixtral-8x7B-v0.1`` at its published width, its depth cut
   to 1 layer (``MIXTRAL_CONFIG``: 1,713,418,240 bf16 parameters, random
   from ``--seed + 9``) is pushed to node A (kernel rows = minted chunks)
   and pulled files-only; the pool lands only its 608,264,192-byte dense
   core and pages experts through a 3-group LRU (page-ins verified 3 each,
   evictions, peak within the budget, residency < 0.5); its tokens at
   batch 1 equal a float32 family decode on the card whose capacity drops
   nothing (same margin rule, router gaps included), whose logits are
   within ``LOGITS_TOL`` of the CPU's float32 forward at every position.
   9b: ``python -m zest_tpu_torch serve --device cuda`` as its own process
   on a fresh node C whose hub is node A's publisher, with
   ``ZEST_HBM_POOL_BYTES=2147483648``: ``POST /v1/generate`` Llama cold
   (9a's tokens), the same streamed (``token`` events, hot), Mixtral cold
   (evicts Llama; 9a's tokens, residency < 0.5), Llama again (cold, the
   same tokens), GPT-2 by sha (no ``pool`` key; phase 5's card tokens);
   ``/v1/metrics`` has cold and hot TTFT and an eviction, ``/v1/status``
   the ``hbm_pool`` block and the daemon's kernel launches (read before
   the first request and after the last), and SIGTERM ends it with exit
   code 0;
11. the mesh landing on four slots of ``cuda:0``. 11a: phase 9r's
   2-layer Llama repo pulled into a fresh node with
   ``mesh=model_mesh({"model": 4}, [cuda:0] * 4)``: ``hbm.sharded``,
   every shard byte-equal to the same slice of the file's tensor, the
   digest 9r's, the peak allocation rise within the landed bytes and two
   commit groups; the tensor-parallel float32 tree
   (``llama.params_from_hf`` of the sharded tree) decodes greedy and
   injected-noise sampled at batch 1 and 4 with logits within
   ``LOGITS_TOL`` of 9r's CPU forward and 9r's tokens (a near-tie below
   twice the tolerance printed). 11b: phase 9's
   Mixtral repo pulled with ``mesh=model_mesh({"expert": 4}, [cuda:0] *
   4)``: the expert-routed pod round (``expert_routed``, 8 experts, the
   routed plan's expert units fetched, 0 failed, gather bytes saved > 0;
   the shared round's kernel #3 and #1 launches and rows as its plan
   predicts), then ``land_moe_expert_sharded`` (slot ``s`` holds experts
   ``2s`` and ``2s + 1`` byte-equal to the file's) and an expert-parallel
   bf16 greedy decode held to phase 9's float32 family tokens by its
   margin rule;
12. the training plane, after every earlier tree is freed (TF32 off).
   12a: GPT-2 at its published width from phase 3's checkpoint: three
   AdamW steps (``models.training``), ``save_train_state``,
   ``restore_train_state`` onto ``cuda:0``, two more; parameters and
   moments bit-equal to an uninterrupted five-step run, the first loss
   within 1e-4 of the port's CPU float32 ``loss_fn``. 12b: Llama-3.2-1B
   at its published width, **depth cut 16 → ``FT_LAYERS`` (2)**, from
   phase 7's snapshot (node ``l``, kept since phase 7; its first layers)
   as a float32 tree on ``cuda:0``: five AdamW steps
   on one seeded (2, 129) batch (the first loss within ``LOGITS_TOL`` of
   the CPU float32 loss, the fifth below the first, no NaN),
   ``export_hf_safetensors``, ``push_checkpoint`` as a new revision of
   phase 7's repo (kernel rows = minted chunks), a delta pull on node
   ``l`` with revision A's whole tree on ``cuda:0`` as ``base_params``:
   its tensors the export's, its digest the export's, its greedy tokens
   at batch 1 and 4 the trainer's own tree's. 12c: Llama-3.2-1B's width cut to 2 layers:
   ``cp_train_step`` over ``{"data": 2, "seq": 4}`` on ``[cuda:0] * 8``
   against ``train_step`` (loss within 1e-5, params within
   ``CP_PARAM_TOL``), and ``pipeline_blocks`` over ``{"pipe": 2}`` (4
   microbatches of a batch of 4) against the plain layer loop, output and
   gradients within ``PIPE_TOL``;
13. the sharded tree's life cycle, on four slots of ``cuda:0``. 13a:
   phase 3's GPT-2 revision A pulled into a fresh node over
   ``model_mesh({"model": 4}, [cuda:0] * 4)`` with the pod pre-pass, then
   ``pull_model(..., mesh=, base_params=, base_revision=)`` to phase 5b's
   revision B: reused shards > 0 and the plan's count, every reused
   ``ShardedTensor`` A's object, the base consumed, the digest a cold
   mesh pull's and 5b's, every slot's shard the file's slice, the
   landing's peak allocation rise within the landed shards and one commit
   group, the pod round's kernel #3/#1 launches and rows those of the
   plan's whole-xorb units (a unit that is only a prefix of its xorb is
   rejected, as predicted), greedy tokens at batch 1 and 4 5b's. 13b:
   phase 7's push pulled at float32 over ``{"data": 2, "model": 2}``,
   ``llama.params_from_hf`` at 12b's depth (the one sharded tree of its
   first ``FT_LAYERS`` layers), three AdamW steps
   with 12b's recipe on 12b's batch cut over ``data``: step-1 loss 12b's within 1e-4
   relative, layer 0's first moments and parameters after step 2 12b's
   (``SHARD_MU_TOL``, ``SHARD_PARAM_BOUND``), the data replicas bit-equal
   after every step, the loss falling, the landing's peak rise (all 16
   layers and the tree built from them) within the landed storages, the
   tree's and two float32 commit groups, the training's within its
   reckoning. 13c: ``cp_train_step`` on the ``ShardedTensor`` tree over
   ``{"seq": 2, "model": 2}`` at 12c's cut against ``train_step`` (loss
   and the gathered ``down_w``). 13d: Mixtral
   at its published width, 1 layer, float32, under ``moe.param_specs``
   over ``{"expert": 4}``: the step-1 loss the CPU float32 loss's within
   ``LOGITS_TOL``, each expert's gradient on its slot, the loss falling,
   the peak rise within its reckoning;
14. the multi-pod pull of phase 3's GPT-2 revision A. 14a: two pods, each
   ``pull_model(..., pods=2, pod_index=i, mesh=model_mesh({"model": 2},
   [cuda:0] * 2))`` into a fresh node; pod 0 first, then pod 1 with pod
   0's cache behind a ``DcnServer`` (``pod_addrs``) and a ``BtServer``
   (pod 1's swarm peer): both digests and files the CPU landing's, pod
   1's ``federated.dcn_units`` the units ``pod_owned_units`` gives pod 0
   with no fallback or failure and their bytes, pod 1's own units from
   the swarm (no CDN byte), CDN bytes over both pods ≤ 1.05 × one
   copy, each pod pre-pass's kernel #3/#1 launches and rows those of its
   plan's whole-xorb units with none rejected, pod 1's greedy tokens at
   batch 1 and 4 phase 5's CPU float32 run's. 14b:
   ``HierarchicalPlan.build(recs, 2, 2)`` distributed over
   ``hier_mesh(2, 2, [cuda:0] * 4)``: every slot's rows byte-equal to a
   CPU distribute of the plan, a fill of a fresh cache through the
   kernels (one launch each per whole-xorb unit, every unit filled), and a
   round with one unit corrupted in flight rejecting it; ``stage_stats()``
   printed. 14c: four coop hosts, pod map ``(0, 0, 1, 1)`` (each pod one
   slice), ``collective_lossy="dcn"``: lossy bytes and ``0 <
   bits_saved_ratio < 1`` on every host, no ZQLS container in any xorb
   cache, the receipt kernels' rows those of the whole xorbs received
   byte-exact, a tree landed through host 1's overlay different from the
   exact tree, each chunk that moved staged quantized and within its
   blocks' bound at the tensors' float grid (at its container's phase
   where the grid's reading overflows float32, the codec fault the JAX
   package shares), every host's file byte-identical once healed through
   the waterfall;
16. the multi-tenant pull service on GPT-2 revisions A and B (5b's), on
   fresh nodes. 16a: one shared tenancy state (two pulls admitted, one
   queued); tenants t0 and t1 pull A onto ``cuda:0`` at once: every CDN
   unit fetched once (≤ 1.02 × one copy), singleflight dedupe hits > 0,
   both digests the CPU landing's, both sessions ok under their tenants;
   t2 pulls B and its token fires when its first layer is resident: the
   session ends ``cancelled``, the card's allocation is back at its level
   before t2, no complete-named safetensors file in t2's snapshot, no
   admission slot held; a re-pull lands B's digest. 16b: ``serve
   --device cuda`` with one admission slot and a one-deep queue, started
   by ``api.daemon.ZestServer``: three ``POST /v1/pull`` of A — one runs
   (its ``done`` with ``time_to_hbm_s`` > 0 and the tree's bytes, its
   files the checkpoint's), one shows ``queued`` in ``/v1/pulls`` and
   ends ``cancelled`` after ``DELETE /v1/pulls/<id>``, one gets 429 with
   ``Retry-After`` before any SSE byte; ``ps --json`` lists both
   terminal; ``GET /v1/debug?tail=8`` holds the queued pull's cancel in
   its recorder tail, the running pull's ``time_to_hbm_s`` in its
   landing block and a telemetry block, ``GET /v1/trace`` answers "no
   tracer armed" and ``GET /v1/metrics?scope=pod`` this host's counters
   as a pod of one; the daemon stops with exit 0. 16c: revision C (A with the
   embeddings and the first two blocks redrawn) hot-swapped over t0's A
   (5b's fetch gate, C's digest), the tree pin now C's; with the disk
   watermark armed below the cache's bytes, an eviction pass removes
   exactly the entries no pin holds, every xorb of A alone among them (at
   least one), and no pinned entry. 0 kernel launches on every path (see
   :func:`tenancy_phase`);
17. the self-healing control plane, the timeline and the engine rebuilt
   with a 1 s anomaly window, a 20 Hz sampler, a straggler patience of 1
   and a token back every second (``HEAL_ENV``). 17a: node B's cache
   seeded by its own ``serve`` process under ``seeder_stall`` (1.5 s a
   response, under the 2 s io-timeout floor); a fresh node pulls A onto
   ``cuda:0`` with it as its direct peer: ``stall`` (or
   ``throughput_collapse``) on the pull's session, a ``hedge`` decision
   executed with its before/after series (it arms the bridge; a
   landing's unit fetches never hedge), phase 4's digest and files,
   ``ring.in_use_bytes`` and ``ring.stalls`` sampled during the pull;
   then a second fresh node pulls A's files only from the same seeder,
   one fetch at a time: its hedge decision executed, and the CDN racing
   the stalled peer on the later fetches (``hedges`` and ``hedges_won``
   at least 1, CDN bytes), files equal to phase 4's; every
   ``fetch.<tier>_bps`` series integrating to its counter's delta within
   the samples' rounding. 17b:
   a two-host collective round of A whose partner (a bare ``DcnServer``)
   holds the first half of its units in the exchange's order: a
   ``collective_straggler`` naming it, the engine's ``strike`` decision
   executed with ``cmd: abort``, ``aborted == "remediation"``, the rest
   down the ladder, phase 4's digest on ``cuda:0``, kernel #3's (and
   #1's) rows exactly the held units' chunks. 17c: two streaming
   landings of A from B's cache through ``stage_cached_to_hbm`` with a
   4 MiB, 2-slot ring: a ``tune`` up decision, the second ring 8 MiB,
   the rails at 32 MiB; an ``HbmPool`` on the card whose watermark holds
   one of two Llama-3.2-1B-width trees (**depth cut 16 → 2**; GPT-2 is
   not a pool family), requested X, Y, X with a sleep after each flush:
   a ``hedge`` whose ``rush`` is seen on the pool, a ``shed`` on
   ``pool_shed``, one tree's allocation after each request and at least
   one tree given back at close. 17d: on node A's publisher, ``/v1/timeline`` paged by
   cursor with no sample repeated, ``?scope=pod`` over a second daemon,
   ``GET``/``POST /v1/remediations`` with the dry-run toggle, the
   dashboard, ``zest top`` and ``zest heal`` exit 0, ``zest diff
   --push-preview`` of revision D (A with ``ln_f.weight`` redrawn), D
   pushed with ``notify_url`` (kernel #1's rows its minted chunks) and
   swapped by a ``watch_and_swap`` onto ``cuda:0`` over 17c's tree: the
   ``push.*`` series equal the push's numbers and the record's
   ``propagation_s`` (see :func:`heal_phase`). Every earlier phase runs
   with the engine on, as by default, and prints its decisions by action
   and outcome;
18. GPT-2's sharded step at its published width (124,439,808 float32
   params): a ``pull --device=cuda`` of revision A over ``{"data": 2,
   "model": 2}`` on four slots of ``cuda:0`` with its pod pre-pass
   (kernel #3's and #1's launches and rows the plan's whole-xorb units),
   ``params_from_hf`` of that landing (no flag: the one sharded tree),
   two AdamW steps with 12a's recipe on 12a's batch cut over ``data``:
   the losses 12a's within 1e-5 relative, the gathered parameters and
   first moments 12a's after step 2 (13b's rules), the replicas
   bit-equal after each step; then greedy decode at batch 1 and 4
   through the ``TPParams`` tree built from the trained tree, its tokens
   those of the unsharded decode of the same trained params;
19. the benches: 19a ``python -m zest_tpu_torch bench --json`` in a
   child on the card (every bench of the JAX package's suite present,
   the device ones included), then ``bench_blake3_device`` in-process,
   its last batch's kernel-#1 digests equal to the plain version's and
   its launches 1 + 3 x 8 of 256 rows (path ``bench``); 19b
   ``bench_gb_pull`` at full Llama-8B width (0.961 GB asked: 2 layers,
   21 tensors, 1,396,744,192 tensor bytes), one timed run onto
   ``cuda:0``: every tensor there, the landed bytes the fixture's, the
   direct landing (path ``bench_gb``); 19c ``bench_coop_pull`` (64 MB,
   four hosts, every DCN server shaped to 50 MB/s and 5 ms a window): 0
   fallbacks, kernel #3's launches the received units with BG4 chunks
   and its rows their BG4 chunks, kernel #1's rows their other chunks
   (path ``bench_coop``), every server's ``DcnServerStats.bytes_served``
   equal to what its peers received and to what it charged its token
   bucket (an unshaped server charges nothing), and its span from its
   first charge to its last charge's return at least (bytes - burst) /
   rate; 19d ``bench_fleet`` at 256 hosts, every gate;

then time each kernel at its path's shapes against its bound, its plain
version and, where one exists, the one PyTorch call that computes the same
function; the fused kernel also beside the two-launch pair it replaced
(the regroup, then the BLAKE3 chunk kernel) in the same run. Every
kernel's launch count is zeroed just before its path runs and read just
after.

Every phase is fatal. Each phase's wall is printed after it; the line
before the last three gives the whole run's wall and those of its
phases. The last three lines of standard output are the
kernels' JSON record (with each kernel's launches by path: the serving
pool's (``serve``), the daemon's (``serve_daemon``), the collective's
(``coop_collective``, ``coop_collective_lane``), phase 20's round
(``coop_wan``), phase 9r's push (``push_pool_llama``), the pod round's
(``pod``), the mesh landing's expert round (``mesh``), the sharded swap's
round (``mesh_swap``), the fine-tune's push (``push_finetune``), the
federated pull's pre-passes (``federated``), the hierarchical fill
(``hier``), the lossy round's receipts (``lossy``), phase 15's four
discovery paths (``tracker``, ``dht``, ``gossip``, ``files_parallel``)
and phase 16's pull service (``tenancy``, ``tenancy_daemon``,
``tenancy_swap``) and phase 17's (``heal_pull``, ``heal_collective``,
``heal_tune``, ``heal_pool``, ``heal_push``) and phase 18's mesh
landing's pre-pass (``mesh_train``) and phase 19's (``bench``,
``bench_gb``, ``bench_coop``) among them), the
card's name and power limit,
and
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
where ``torch.cuda.is_available()`` is false. Needs one card, no network.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
import weakref
from pathlib import Path

import numpy as np

REPO = "openai-community/gpt2"
REPO_SHARDED = REPO + "-sharded"  # phase 4b's second repo
GPT2_CONFIG = {  # openai-community/gpt2's published config.json
    "model_type": "gpt2", "architectures": ["GPT2LMHeadModel"],
    "vocab_size": 50257, "n_positions": 1024, "n_ctx": 1024, "n_embd": 768,
    "n_layer": 12, "n_head": 12, "layer_norm_epsilon": 1e-05,
    "activation_function": "gelu_new", "bos_token_id": 50256,
    "eos_token_id": 50256,
}
# Every leaf count 1-128 (1024n - 1 bytes is n leaves), and both sides of
# each 32-leaf group edge: the kernels fold a group in a warp and join a
# chunk's groups across warps.
LEAF_LENGTHS = tuple(1024 * n - 1 for n in range(1, 129)) + tuple(
    min(32768 * k + d, 131072) for k in range(1, 5) for d in (0, 1))
KERNEL_LENGTHS = tuple(sorted(set(
    (0, 1, 63, 64, 1023, 1024, 1025, 2049, 65536, 131072) + LEAF_LENGTHS)))
BG4_LENGTHS = tuple(sorted(set(
    (0, 1, 2, 3, 4, 5, 1023, 1024, 1025, 65535, 65536, 131072)
    + LEAF_LENGTHS)))
COOP_HOSTS = 4
# Phase 20: the collective over a pod map through WAN-shaped servers. Each
# host its own slice, two pods of two: every host has a DCN partner in its
# pod, and the pods' gateways (hosts 0 and 2) exchange over WAN. Each
# server shapes a cross-slice connection to 200 MB/s and 5 ms a request
# window, a cross-pod one to 50 MB/s and 20 ms.
WAN_SLICES = (0, 1, 2, 3)
WAN_PODS = (0, 0, 1, 1)
WAN_SHAPING = {"rate_bps": 200_000_000, "window_rtt_s": 0.005,
               "wan_bps": 50_000_000, "wan_rtt_s": 0.020}
# Phase 10: four slots on cuda:0 (one card), and a pool budget below two
# of GPT-2's ~67 MB units per slot, so the round takes several waves.
POD_SLOTS = 4
POD_BUDGET = 256 * 1024 * 1024
# Phase 5b's revision B: a fine-tune of the last block's MLP and the final
# norm, 4,720,128 of GPT-2's 124,439,808 parameters.
REDRAWN = ("h.11.mlp.c_fc.weight", "h.11.mlp.c_proj.weight", "ln_f.weight",
           "ln_f.bias")
# Phase 16c's revision C: A with the embeddings and the first two blocks
# drawn again, the file's first 214 MB. A xorb of A covers ~71 MB of the
# file, so at least one of them holds only chunks C no longer references.
REDRAWN_C = ("wte.", "wpe.", "h.0.", "h.1.")
MAX_LANDED = 12
# Phase 7: meta-llama/Llama-3.2-1B's published config.json, full width and
# depth (1,235,814,400 parameters in 146 bf16 tensors, embeddings tied).
LLAMA_REPO = "meta-llama/Llama-3.2-1B"
LLAMA_CONFIG = {
    "architectures": ["LlamaForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 128000,
    "eos_token_id": 128001, "head_dim": 64, "hidden_act": "silu",
    "hidden_size": 2048, "initializer_range": 0.02,
    "intermediate_size": 8192, "max_position_embeddings": 131072,
    "mlp_bias": False, "model_type": "llama", "num_attention_heads": 32,
    "num_hidden_layers": 16, "num_key_value_heads": 8, "pretraining_tp": 1,
    "rms_norm_eps": 1e-05,
    "rope_scaling": {"factor": 32.0, "high_freq_factor": 4.0,
                     "low_freq_factor": 1.0,
                     "original_max_position_embeddings": 8192,
                     "rope_type": "llama3"},
    "rope_theta": 500000.0, "tie_word_embeddings": True,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 128256,
}
LLAMA_TENSORS, LLAMA_PARAMS = 146, 1_235_814_400
# Phase 9's pool trees and 11a's {"model": 4} landing: Llama-3.2-1B's
# width, its depth cut 16 -> 2 (as 12b, 12c, 13c and 17c), pushed as a
# repo of its own. Phase 7 keeps the full depth.
POOL_LAYERS = 2
POOL_REPO = LLAMA_REPO + "-2-layers"
POOL_CONFIG = dict(LLAMA_CONFIG, num_hidden_layers=POOL_LAYERS)
# Phase 9: mistralai/Mixtral-8x7B-v0.1's published config.json at its
# width, its depth cut from 32 layers to 1 (the push encodes ~14-20 s a
# GB on the host): 1,713,418,240 bf16 parameters, a 608,264,192-byte
# dense core and eight 352,321,536-byte expert groups.
MIXTRAL_REPO = "mistralai/Mixtral-8x7B-v0.1"
MIXTRAL_CONFIG = {
    "architectures": ["MixtralForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "hidden_size": 4096, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_position_embeddings": 32768,
    "model_type": "mixtral", "num_attention_heads": 32,
    "num_experts_per_tok": 2, "num_hidden_layers": 1,
    "num_key_value_heads": 8, "num_local_experts": 8,
    "output_router_logits": False, "rms_norm_eps": 1e-05,
    "rope_theta": 1000000.0, "router_aux_loss_coef": 0.02,
    "sliding_window": None, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True, "vocab_size": 32000,
}
MIXTRAL_PARAMS = 1_713_418_240
MIXTRAL_DENSE_BYTES, MIXTRAL_EXPERT_BYTES = 608_264_192, 2_818_572_288
MIXTRAL_PAGER_BYTES = 1_056_964_608  # EXPERT_BUDGET_FRACTION: 3 groups
# Phase 9b's pool watermark: each of the two trees fits alone (Llama at
# POOL_LAYERS, 768,626,688 B; Mixtral's core and pager budget
# 1,665,228,800 B), the two together do not.
DAEMON_POOL = 2 << 30
# Phase 7's sampled decode.
SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.9}
# Phase 7's logits gate: the largest |card - CPU| over every position's
# logits, both in float32 (TF32 off). Measured on an H100 (seed 0): 1.57e-5
# in float32 (summation order only), 8.3e-3 with TF32 on, 0.17 with the
# tree in bf16, for logits of standard deviation ~1. The gate sits ~6x
# above the float32 error and ~80x below TF32's, so a TF32 product fails.
LOGITS_TOL = 1e-4
# Phase 7's time_to_hbm_s over earlier untraced runs (PERF.md §5; NVIDIA
# H100 80GB HBM3, 700 W), the traced pull's yardstick.
LLAMA_TTH_UNTRACED_S = (6.53, 8.79)
# Phase 4b: save_pretrained(max_shard_size="200MB") (decimal megabytes),
# and a ring that the landing must reuse many times over.
SHARD_BYTES = 200 * 1000 * 1000
TIGHT_RING = {"land_ring_bytes": 64 * 1024 * 1024, "land_ring_slots": 4}
# The header probe of a cooperative pull reads whole chunk frames until
# the safetensors header is complete: at most the header and one more
# chunk (128 KiB), twice over for the frames' own bytes.
MAX_CHUNK_BYTES = 128 * 1024
# NVIDIA H100 SXM data sheet: 3.35 TB/s HBM3. Integer rate: 64 INT32
# lanes per SM x 132 SMs x 1.98 GHz boost clock (the same data sheet's
# clock behind its 67 TFLOP/s float32 figure: 128 FP32 lanes x 2 x 132 x
# 1.98 GHz).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# One compression as the source counts it: 7 rounds x 8 G x 12 u32
# instructions + 8 xors for the 8 output words (a G as written is 14 ops,
# but each ``a + b + m`` issues as one three-input add, IADD3). Printed
# beside the bound; the bound itself counts the compiled instructions.
SOURCE_OPS_PER_COMPRESSION = 7 * 8 * 12 + 8
# What the bound counts instead: the SASS of one compression, from a probe
# kernel built in phase 1 around csrc/blake3.cu's ``compress`` (its inputs
# come from memory, so nothing folds to a constant). Integer adds, logic,
# shifts, permutes and compares issue on the ALU pipe and IMAD on the FMA
# pipe, 64 lanes an SM each, while the schedulers issue 128 lanes an SM a
# clock: a compression takes the longest of the three.
ALU_PIPE = ("IADD3", "LOP3", "SHF", "PRMT", "ISETP", "SEL", "LEA", "IMNMX")
FMA_PIPE = ("IMAD",)
PROBE = """#include "{source}"
extern "C" __global__ void probe_compress(uint32_t* io) {{
  uint32_t cv[8], m[16], out[8];
  for (int i = 0; i < 8; ++i) cv[i] = io[i];
  for (int i = 0; i < 16; ++i) m[i] = io[8 + i];
  compress(cv, m, io[24], io[25], io[26], out);
  for (int i = 0; i < 8; ++i) io[i] = out[i];
}}
"""


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def gpt2_checkpoint(seed: int, cfg: dict) -> dict:
    """HF-named float32 GPT-2 tensors from a numpy seed (LayerNorm
    weights one, biases zero, weights N(0, 0.02))."""
    import torch

    rng = np.random.default_rng(seed)
    E, L, V = cfg["n_embd"], cfg["n_layer"], cfg["vocab_size"]

    def w(*shape, scale=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            scale)

    t = {"wte.weight": w(V, E), "wpe.weight": w(cfg["n_positions"], E,
                                                 scale=0.01)}
    for i in range(L):
        p = f"h.{i}."
        t[p + "ln_1.weight"] = np.ones(E, np.float32)
        t[p + "ln_1.bias"] = np.zeros(E, np.float32)
        t[p + "attn.c_attn.weight"] = w(E, 3 * E)
        t[p + "attn.c_attn.bias"] = w(3 * E)
        t[p + "attn.c_proj.weight"] = w(E, E)
        t[p + "attn.c_proj.bias"] = w(E)
        t[p + "ln_2.weight"] = np.ones(E, np.float32)
        t[p + "ln_2.bias"] = np.zeros(E, np.float32)
        t[p + "mlp.c_fc.weight"] = w(E, 4 * E)
        t[p + "mlp.c_fc.bias"] = w(4 * E)
        t[p + "mlp.c_proj.weight"] = w(4 * E, E)
        t[p + "mlp.c_proj.bias"] = w(E)
    t["ln_f.weight"] = np.ones(E, np.float32)
    t["ln_f.bias"] = np.zeros(E, np.float32)
    return {k: torch.from_numpy(v) for k, v in t.items()}


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events,
    after one warm-up call)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs_err(a, b) -> int:
    """Largest |a - b| over two u32 tensors of one shape, as integers."""
    import torch

    def wide(t):
        return t.view(torch.int32).long() & 0xFFFFFFFF

    return int((wide(a) - wide(b)).abs().max()) if a.numel() else 0


def blake3_work(lengths: np.ndarray) -> tuple[int, int]:
    """``(bytes, compressions)`` the kernel needs for these chunk lengths:
    it reads each row up to its length rounded up to a 64-byte block (at
    least one block), plus a 4-byte length, and writes a 32-byte digest;
    it runs one compression per block plus one per parent node."""
    leaves = np.maximum((lengths + 1023) // 1024, 1)
    blocks = np.maximum((lengths + 63) // 64, 1)
    nbytes = int(blocks.sum()) * 64 + len(lengths) * (4 + 32)
    return nbytes, int(blocks.sum() + (leaves - 1).sum())


def compression_sass(work: Path) -> dict[str, int]:
    """Opcode counts of one compression: the probe kernel around
    csrc/blake3.cu's ``compress``, compiled for sm_90a and read back with
    ``cuobjdump -sass``."""
    from zest_tpu_torch.ops import blake3_cuda, nvcc

    work.mkdir(parents=True, exist_ok=True)
    probe, cubin = work / "probe.cu", work / "probe.cubin"
    probe.write_text(PROBE.format(source=blake3_cuda.SOURCE.as_posix()))
    subprocess.run([nvcc.nvcc(), "-cubin", *nvcc.NVCC_FLAGS[:4], "-o",
                    str(cubin), str(probe)], check=True, capture_output=True)
    tool = Path(nvcc.nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    counts: dict[str, int] = {}
    inside = False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "probe_compress" in line
            continue
        m = re.match(r"\s*/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                     line)
        if inside and m:
            counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return counts


def build_all(work: Path) -> tuple[int, int]:
    """Phase 1: both kernel sources and the compression probe (one nvcc
    each, side by side) and the native host library; prints each kernel's
    registers and spills and the probe's SASS. Returns one compression's
    ``(ALU-pipe, FMA-pipe)`` instruction counts."""
    from zest_tpu_torch import native
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda, nvcc

    logs, errors = {}, []

    def build(name, fn):
        t0 = time.monotonic()
        try:
            logs[name] = (fn(), time.monotonic() - t0)
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    jobs = [(m.SOURCE.name, m.build) for m in (blake3_cuda, bg4_cuda)]
    jobs.append(("probe", lambda: compression_sass(work / "probe")))
    threads = [threading.Thread(target=build, args=j) for j in jobs]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    t1 = time.monotonic()
    native.build()
    print(f"phase 1 build: kernels {t1 - t0:.2f} s in parallel "
          f"(nvcc {' '.join(nvcc.NVCC_FLAGS)}); native host library "
          f"{time.monotonic() - t1:.2f} s (g++)")
    sass, _ = logs.pop("probe")
    for name, (ptxas, secs) in sorted(logs.items()):
        print(f"  {name}: {secs:.2f} s")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    alu = sum(sass.get(op, 0) for op in ALU_PIPE)
    fma = sum(sass.get(op, 0) for op in FMA_PIPE)
    if alu < 7 * 8 * 8:  # at least a xor and a rotate per G step
        fail(f"the compression probe's SASS has {alu} ALU instructions: "
             f"{sass}")
    print(f"  SASS of one compression: ALU pipe {alu}, FMA pipe {fma} "
          f"(source {SOURCE_OPS_PER_COMPRESSION}); "
          + ", ".join(f"{k} {v}" for k, v in sorted(sass.items())))
    return alu, fma


def op_ms(alu: int, fma: int) -> float:
    """Least device time of ``alu`` ALU-pipe and ``fma`` FMA-pipe integer
    instructions (lanes): each pipe at 64 lanes an SM a clock, issue at
    128."""
    return max(alu, fma, (alu + fma) / 2) / INT32_OPS_PER_S * 1e3


def bg4_phase(rng, dev) -> None:
    """Phase 2b: the regroup kernel and the fused kernel against their
    plain versions and the native host decode + BLAKE3."""
    import torch

    from zest_tpu_torch import native
    from zest_tpu_torch.cas import compression, hashing
    from zest_tpu_torch.ops import bg4, bg4_cuda
    from zest_tpu_torch.ops.blake3 import digests_to_bytes

    bg4_scheme = compression.Scheme.BG4_LZ4
    chunks = [(rng.standard_normal(-(-n // 4), dtype=np.float32)
               * np.float32(0.02)).tobytes()[:n] for n in BG4_LENGTHS]
    payloads = [compression.compress(c, bg4_scheme) for c in chunks]
    host = [compression.decompress(f, bg4_scheme, len(c))
            for f, c in zip(payloads, chunks)]
    if host != chunks:
        fail("native host BG4 decode does not round-trip")
    planar = [compression.lz4_frame_decompress(f, len(c))
              for f, c in zip(payloads, chunks)]
    words, lengths = bg4.stage_planar(planar, list(BG4_LENGTHS), dev)
    raw = words.view(torch.uint8)
    slot = raw.shape[1] // 4
    keep = torch.zeros(raw.shape, dtype=torch.bool)
    for i, n in enumerate(BG4_LENGTHS):
        for k, size in enumerate(bg4.bg4_plane_sizes(n)):
            keep[i, k * slot:k * slot + size] = True
    junk = torch.randint(0, 256, raw.shape, device=dev, dtype=torch.uint8)
    dirty = torch.where(keep.to(dev), raw, junk).contiguous().view(
        torch.uint32)
    for w in (words, dirty):
        got = bg4_cuda.launch(w)
        if max_abs_err(got, bg4.regroup_words(w)):
            fail("BG4 regroup kernel != plain regroup")
        rows = got.cpu().view(torch.uint8).numpy()
        if any(rows[i, :len(c)].tobytes() != c for i, c in enumerate(host)):
            fail("BG4 regroup kernel != native host decode")
    for key in (None, hashing.CHUNK_KEY):
        v = bg4.FusedBg4Verifier(key, dev)
        want = [native.lib.blake3(c) if key is None
                else native.lib.blake3_keyed(key, c) for c in host]
        for w in (words, dirty):
            got = v.hash_planar_device(w, lengths)
            plain = bg4.fused_regroup_hash(w, lengths, v.key_words,
                                           v.base_flags)
            if max_abs_err(got, plain):
                fail(f"fused kernel != plain fused "
                     f"(keyed={key is not None})")
            if digests_to_bytes(got) != want:
                fail(f"fused kernel != native decode + BLAKE3 "
                     f"(keyed={key is not None})")
    torch.cuda.synchronize()
    print(f"phase 2b bg4 regroup and fused kernel == plain == native decode "
          f"+ BLAKE3 on {len(chunks)} lengths (0-5, every leaf count 1-128, "
          f"the 32-leaf group edges, 64 and 128 KiB), plain and keyed, "
          f"garbage past every plane")


def bg4_chunks_of(blob: bytes) -> tuple[int, int]:
    """``(BG4 chunks, other chunks)`` of a xorb."""
    from zest_tpu_torch.cas.compression import Scheme
    from zest_tpu_torch.cas.xorb import XorbReader

    schemes = XorbReader(blob).chunk_schemes
    bg4 = int((schemes == int(Scheme.BG4_LZ4)).sum())
    return bg4, len(schemes) - bg4


def check_files(label: str, res, ckpt: Path) -> None:
    for f in sorted(ckpt.iterdir()):
        if (res.snapshot_dir / f.name).read_bytes() != f.read_bytes():
            fail(f"{label}: pulled {f.name} differs from the pushed file")


def check_tree(label: str, res, digest: str, dev) -> None:
    from zest_tpu_torch.models.loader import params_digest

    off = [n for n, t in res.params.items() if t.device != dev]
    if off:
        fail(f"{label}: {len(off)} tensors not on {dev}: {off[:3]}")
    if params_digest(res.params) != digest:
        fail(f"{label}: params_digest != the CPU landing's")


def check_direct(label: str, res) -> None:
    """The streaming landing's own gates: direct and streamed, the first
    layer resident before the rest, the ring within its budget (a tensor
    larger than the ring is admitted alone: then within that tensor and
    its slot's 16-byte alignment), and the shards' files written from the
    ring slots."""
    st = res.stats
    hbm = st["hbm"]
    if not (hbm["direct"] and hbm.get("streamed")):
        fail(f"{label}: the landing did not stream from the cache: "
             f"direct {hbm['direct']}, streamed {hbm.get('streamed')}")
    tfl, tth = st.get("time_to_first_layer_s"), st["time_to_hbm_s"]
    if tfl is None or not 0 < tfl < tth:
        fail(f"{label}: time_to_first_layer_s {tfl} vs time_to_hbm_s {tth}")
    ring = hbm["ring"]
    biggest = max(int(t.nbytes) for t in res.params.values())
    bound = max(ring["budget_bytes"], biggest + 15)
    if ring["peak_bytes"] > bound:
        fail(f"{label}: ring peak {ring['peak_bytes']:,} B > {bound:,} B "
             f"(budget {ring['budget_bytes']:,} B)")
    if not st["files_pipeline"]["lane_bytes"].get("tensors"):
        fail(f"{label}: no file was written from the ring slots: "
             f"{st['files_pipeline']}")


def landing_summary(st: dict) -> str:
    stages = st["stages"]
    out = (f"time_to_hbm_s {st['time_to_hbm_s']}, elapsed_s "
           f"{st['elapsed_s']}; stages "
           + ", ".join(f"{k} {stages[k]}" for k in (
               "resolve", "cas_metadata", "fetch", "decode", "first_layer",
               "hbm_commit", "files") if k in stages)
           + f"; files_after_hbm_s {st['files_after_hbm_s']}")
    if "time_to_first_layer_s" in st:
        out = f"time_to_first_layer_s {st['time_to_first_layer_s']}, " + out
    return out


def hf_shards(tensors: dict, max_bytes: int) -> list[dict]:
    """``tensors`` split in their order into shards of at most
    ``max_bytes`` (a larger tensor alone), as ``save_pretrained`` lays
    out a sharded checkpoint."""
    shards, size = [{}], 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        if shards[-1] and size + n > max_bytes:
            shards.append({})
            size = 0
        shards[-1][name] = t
        size += n
    return shards


def write_sharded(root: Path, tensors: dict, config: dict) -> list[str]:
    """A sharded HF checkpoint of ``tensors``: ``model-0000i-of-0000n``
    files plus ``model.safetensors.index.json``. Returns the shard names."""
    from zest_tpu_torch.models.safetensors_io import write_safetensors

    shards = hf_shards(tensors, SHARD_BYTES)
    root.mkdir()
    (root / "config.json").write_text(json.dumps(config, indent=2))
    weight_map, names = {}, []
    for i, shard in enumerate(shards, 1):
        name = f"model-{i:05d}-of-{len(shards):05d}.safetensors"
        write_safetensors(root / name, shard)
        weight_map.update(dict.fromkeys(shard, name))
        names.append(name)
    total = sum(t.numel() * t.element_size() for t in tensors.values())
    (root / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map},
        indent=2))
    return names


def pull_phase(work: Path, url: str, cfg_a, ckpt: Path, pushed, dev):
    """Phase 4: the pull into a fresh node B through the direct streaming
    landing. Returns the result, node B's config and the CPU landing's
    digest."""
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.transfer.pull import pull_model

    cfg_b = Config(hf_home=work / "b" / "hf",
                   cache_dir=work / "b" / "zest", endpoint=url)
    # No swarm (the CLI's --no-p2p): the warm fetch's stream tier.
    pulled = pull_model(cfg_b, REPO, device=dev, no_p2p=True)
    st = pulled.stats
    if st["fallback_files"]:
        fail(f"{st['fallback_files']} xet files fell back to a "
             "whole-file download: the cache → CDN reconstruction "
             "failed")
    cdn = st["fetch"]["bytes"]["cdn"]
    if not pushed.new_xorb_bytes <= cdn <= 1.05 * pushed.new_xorb_bytes:
        fail(f"node B started empty, so one copy of the "
             f"{pushed.new_xorb_bytes:,} minted xorb bytes must cross "
             f"the CDN tier: {st['fetch']}")
    check_files("phase 4", pulled, ckpt)
    digest = params_digest(load_checkpoint(pulled.snapshot_dir, "cpu"))
    check_tree("phase 4", pulled, digest, dev)
    check_direct("phase 4", pulled)
    # The stream tier (no swarm): every wanted unit streamed into the
    # cache; the cache holds no temp file and no short entry (a full key
    # hashes to its xorb, a partial one parses), and every CDN byte is in
    # it exactly once (the streamed units and the header prefetch's).
    from zest_tpu_torch.cas import hashing
    from zest_tpu_torch.cas.xorb import XorbReader

    warm = st["hbm"].get("warm") or {}
    files = [f for f in cfg_b.xorb_cache_dir().rglob("*") if f.is_file()]
    short = [f.name for f in files if f.name.startswith(".tmp-")]
    for f in files:
        data = f.read_bytes()
        try:
            whole = len(f.name) == 64
            if whole and XorbReader(data).xorb_hash() != \
                    hashing.hex_to_hash(f.name):
                short.append(f.name)
            elif not whole:
                XorbReader(data)
        except ValueError:
            short.append(f.name)
    cached = sum(f.stat().st_size for f in files)
    lanes = st["files_pipeline"]["lane_bytes"]
    want_lanes = {"tensors": (ckpt / "model.safetensors").stat().st_size,
                  "waterfall": (ckpt / "config.json").stat().st_size}
    if "swarm" in st or short or not warm.get("units") or warm["failed"] \
            or cdn != cached or warm["bytes"] > cdn or lanes != want_lanes:
        fail(f"phase 4: warm {warm}, fetch {st['fetch']}, cache {cached:,} "
             f"B, short or temp entries {short}; lanes {lanes} (want "
             f"{want_lanes})")
    print(f"phase 4 pull: {landing_summary(st)}; ring "
          f"{st['hbm']['ring']}; {cdn:,} bytes in "
          f"{st['fetch']['xorbs']['cdn']} CDN fetches, 0 fallbacks; "
          f"fetch by tier {st['fetch']['xorbs']} xorbs, "
          f"{st['fetch']['bytes']} B; stream tier: warm {warm}, the cache's "
          f"{len(files)} entries hold {cached:,} B = the CDN bytes, no short "
          f"entry; files by lane {lanes}; "
          f"{st['hbm']['tensors']} tensors on {dev}, digest "
          f"{digest[:16]}")
    return pulled, cfg_b, digest


def sharded_phase(work: Path, url: str, cfg_a, tensors: dict, digest: str,
                  dev) -> int:
    """Phase 4b: the three-shard checkpoint pushed as a second repo, then
    pulled into a fresh node through a tight ring. Returns the push's
    BLAKE3 kernel launches."""
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    ckpt = work / "checkpoint-sharded"
    shards = write_sharded(ckpt, tensors, GPT2_CONFIG)
    if len(shards) != 3:
        fail(f"phase 4b: {len(shards)} shards at {SHARD_BYTES:,} B, not 3")
    for c in (blake3_cuda.COUNTER, bg4_cuda.COUNTER, bg4_cuda.FUSED_COUNTER):
        c.reset()  # counts from here are the sharded push's
    pushed = push_checkpoint(cfg_a, REPO_SHARDED, ckpt, device=dev,
                             notify=False)
    launches = blake3_cuda.COUNTER.launches
    if blake3_cuda.COUNTER.rows != pushed.minted_chunks:
        fail(f"phase 4b: kernel hashed {blake3_cuda.COUNTER.rows} chunks, "
             f"push minted {pushed.minted_chunks}")
    cfg = Config(hf_home=work / "d" / "hf", cache_dir=work / "d" / "zest",
                 endpoint=url, **TIGHT_RING)
    res = pull_model(cfg, REPO_SHARDED, device=dev)
    st = res.stats
    label = "phase 4b"
    if st["fallback_files"]:
        fail(f"{label}: {st['fallback_files']} whole-file fallbacks")
    check_files(label, res, ckpt)
    check_tree(label, res, digest, dev)
    check_direct(label, res)
    ring, warm = st["hbm"]["ring"], st["hbm"]["warm"]
    if ring["buffer_reuses"] <= 0:
        fail(f"{label}: the ring never reused a slot: {ring}")
    if (warm["pipelined_shards"] != len(shards) or warm["failed"]
            or warm.get("prefetch_errors")):
        fail(f"{label}: not every shard was warmed: {warm}")
    print(f"phase 4b sharded pull: {len(shards)} shards "
          f"({', '.join(f'{(ckpt / s).stat().st_size:,} B' for s in shards)}"
          f"; push {pushed.new_xorbs} new xorbs, {pushed.minted_chunks} "
          f"chunks in {pushed.elapsed_s:.2f} s, kernel launches {launches}); "
          f"{landing_summary(st)}; ring {ring}; warm {warm}; digest equal")
    return launches


def resume_phase(cfg_b, digest: str, dev) -> None:
    """Phase 4c: phase 4's repo pulled again into node B. Every file is
    complete, so the landing stages from disk."""
    from zest_tpu_torch.transfer.pull import pull_model

    res = pull_model(cfg_b, REPO, device=dev)
    st = res.stats
    if st["hbm"]["direct"] or st["files_downloaded"]:
        fail(f"phase 4c: direct {st['hbm']['direct']}, "
             f"{st['files_downloaded']} files downloaded: the complete "
             "snapshot must stage from disk")
    check_tree("phase 4c", res, digest, dev)
    print(f"phase 4c resumed pull: {st['files_skipped']} files complete, "
          f"staged from disk; {landing_summary(st)}; digest equal")


def revision_b(tensors: dict, seed: int, names=REDRAWN) -> dict:
    """Phase 5b's revision: ``tensors`` with ``names`` drawn again from
    ``seed`` (weights N(0, 0.02), a norm's weight 1 + N(0, 0.02) and its
    bias N(0, 0.02)). Phase 16c's revision C passes its own names."""
    import torch

    rng = np.random.default_rng(seed)
    out = dict(tensors)
    for name in names:
        shape = tuple(tensors[name].shape)
        v = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        if re.search(r"(^|\.)ln_\w+\.weight$", name):
            v += np.float32(1.0)
        out[name] = torch.from_numpy(v)
    return out


def swap_phase(work: Path, url: str, publisher, cfg_a, cfg_b, pulled,
               sha_a: str, tensors_b: dict, prompts, steps: int,
               tth_a: float, dev) -> dict:
    """Phase 5b: node B's watcher delta-pulls and swaps revision B into
    phase 4's tree. Returns the push's BLAKE3 kernel launches and what
    phase 13a holds its sharded swap to: B's sha and digest, the swap's
    time and the greedy tokens at batch 1 and 4."""
    import torch

    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.ops import blake3_cuda
    from zest_tpu_torch.transfer.push import push_checkpoint, watch_and_swap

    ckpt_b = work / "checkpoint-b"
    ckpt_b.mkdir()
    (ckpt_b / "config.json").write_text(json.dumps(GPT2_CONFIG, indent=2))
    write_safetensors(ckpt_b / "model.safetensors", tensors_b)
    # The caller hands A's tree over: nothing else may hold it.
    base = pulled.params
    pulled.params = None
    # Weak references: they tell a reused tensor from a landed one
    # without keeping A's tensors alive.
    refs = {n: weakref.ref(t) for n, t in base.items()}
    ptrs = {n: t.data_ptr() for n, t in base.items()}
    a_bytes = sum(t.numel() * t.element_size() for t in base.values())
    mem: dict = {}
    seen, errors = [], []

    def log(*a, **k):
        msg = " ".join(str(x) for x in a)
        if msg.startswith("watch:"):
            # The pull starts right after this line, in this thread.
            torch.cuda.synchronize(dev)
            mem["before"] = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        print(f"  [node B] {msg}", file=sys.stderr)

    def watch():
        try:
            watch_and_swap(cfg_b, REPO, publisher_url=url, device=dev,
                           base_params=base, base_revision=sha_a,
                           max_events=1, timeout_s=600,
                           on_swap=lambda rec, res: seen.append((rec, res)),
                           log=log)
            mem["peak"] = torch.cuda.max_memory_allocated(dev)
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    watcher = threading.Thread(target=watch, name="phase-5b-watch")
    watcher.start()
    try:
        deadline = time.monotonic() + 60
        while publisher.hub.watchers() < 1:
            if time.monotonic() > deadline or not watcher.is_alive():
                fail("phase 5b: node B never subscribed to the publisher")
            time.sleep(0.01)
        blake3_cuda.COUNTER.reset()  # counts from here are the push's
        pushed = push_checkpoint(cfg_a, REPO, ckpt_b, base_revision=sha_a,
                                 notify=True, notify_url=url, device="cuda")
        launches, rows = (blake3_cuda.COUNTER.launches,
                          blake3_cuda.COUNTER.rows)
    finally:
        watcher.join(timeout=900)
    if errors:
        raise errors[0]
    if watcher.is_alive() or len(seen) != 1:
        fail(f"phase 5b: the watcher swapped {len(seen)} revisions")
    if launches < 1 or rows != pushed.minted_chunks:
        fail(f"phase 5b: the push's kernel hashed {rows} chunks in "
             f"{launches} launches; it minted {pushed.minted_chunks}")
    if not pushed.notified or pushed.notified.get("delivered") != 1:
        fail(f"phase 5b: the push notified {pushed.notified}")
    record, res = seen[0]
    st = res.stats
    if record["revision"] != pushed.revision or pushed.revision == sha_a:
        fail(f"phase 5b: the record names {record['revision']}, the push "
             f"{pushed.revision}")
    d = st.get("delta")
    if not d or not d["delta_bytes_ratio"] < 0.1:
        fail(f"phase 5b: delta {d and {k: v for k, v in d.items() if k != 'files'}}")
    stale = d.get("stale_bytes", 0)
    if not 0 < d["fetched_bytes"] <= d["changed_bytes"] + stale:
        fail(f"phase 5b: fetched {d['fetched_bytes']} B, changed "
             f"{d['changed_bytes']} + stale {stale} B")
    swap = st["hbm"]["swap"]
    params = res.params
    reused = {n for n, t in params.items()
              if n in refs and refs[n]() is t}
    landed = set(params) - reused
    moved = sorted(n for n in reused if params[n].data_ptr() != ptrs[n])
    if moved:
        fail(f"phase 5b: reused tensors off A's data_ptr: {moved}")
    if swap["reused_tensors"] + swap["landed_tensors"] != 148 \
            or len(params) != 148 or len(landed) != swap["landed_tensors"]:
        fail(f"phase 5b: swap {swap}, {len(landed)} tensors moved")
    if not set(REDRAWN) <= landed or len(landed) > MAX_LANDED:
        fail(f"phase 5b: landed {sorted(landed)}")
    if base:
        fail(f"phase 5b: {len(base)} tensors left in the base dict")
    group = min(64 * 1024 * 1024, cfg_b.land_ring_bytes // 4)
    rise = mem["peak"] - mem["before"]
    if rise > swap["landed_bytes"] + group:
        fail(f"phase 5b: the peak allocation rose {rise:,} B, above the "
             f"landed {swap['landed_bytes']:,} B + one group {group:,} B")
    want = params_digest(load_checkpoint(ckpt_b, "cpu"))
    check_tree("phase 5b", res, want, dev)
    check_files("phase 5b", res, ckpt_b)
    lanes = st["files_pipeline"]["lane_bytes"]
    if not lanes.get("copy", 0) + lanes.get("decode", 0):
        fail(f"phase 5b: no file bytes from the cache lane: {lanes}")
    _, gen_cuda = load_generator(res.snapshot_dir, device=dev,
                                 tensors=params)
    _, gen_cpu = load_generator(res.snapshot_dir, device="cpu")
    tokens = {}
    for batch in ([prompts[0]], prompts):
        out = gen_cuda(batch, steps, stop_at_eos=False)
        if not np.array_equal(out, gen_cpu(batch, steps,
                                           stop_at_eos=False)):
            fail(f"phase 5b: batch {len(batch)}: cuda tokens != cpu tokens")
        tokens[len(batch)] = out
    reused_bytes = sum(params[n].numel() * params[n].element_size()
                       for n in reused)
    print(f"phase 5b hot-swap: time_to_swap_s {st['time_to_swap_s']} "
          f"(phase 4 time_to_hbm_s {tth_a}), propagation_s "
          f"{record.get('propagation_s')}; push {pushed.new_xorbs} new "
          f"xorbs, {pushed.minted_chunks} chunks in {pushed.elapsed_s:.2f} "
          f"s, kernel launches {launches}; delta_bytes_ratio "
          f"{d['delta_bytes_ratio']}, changed {d['changed_bytes']:,} B, "
          f"fetched {d['fetched_bytes']:,} B, stale {stale:,} B; reused "
          f"{len(reused)} tensors ({reused_bytes:,} B, A {a_bytes:,} B), "
          f"landed {sorted(landed)} ({swap['landed_bytes']:,} B); peak "
          f"allocation +{rise:,} B; {landing_summary(st)}; files by lane "
          f"{lanes}; digest and decode at batch 1 and 4 equal to the CPU's")
    del gen_cuda, gen_cpu, params
    res.params = None
    return {"launches": launches, "revision": pushed.revision,
            "digest": want, "time_to_swap_s": st["time_to_swap_s"],
            "tokens": tokens, "prompts": prompts, "steps": steps}


def coop_phase(work: Path, url: str, ckpt: Path, pushed, cfg_a,
               digest: str, dev, revision: str, label: str = "phase 6",
               schedule: str | None = None, traced: bool = False,
               shaping: dict | None = None, **cfg_kw) -> dict:
    """Phase 6 (the point-to-point exchange) and, with ``schedule``, 6c,
    6d and 20 (the collective, expected to run that schedule in 2
    phases): ``COOP_HOSTS`` cooperative pulls of ``revision`` in threads,
    their configs given ``cfg_kw``. Returns the launch counts of the
    path; the counters of the transports the hosts' collectives built are
    printed and, for the device lane, gated. Each host's thread runs under
    its host index as trace context and its DCN server stamps that index
    on its spans; ``traced`` installs a tracer for the pulls and holds the
    trace to :func:`coop_trace_gates`. ``shaping`` (phase 20) gives every
    server those ``DcnServer`` knobs over the configs' slice and pod maps,
    and holds the round to :func:`link_gates`."""
    from zest_tpu_torch import telemetry
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.transfer import collective
    from zest_tpu_torch.transfer.dcn import DcnServer
    from zest_tpu_torch.transfer.pull import pull_model

    n = COOP_HOSTS
    tag = label.split()[-1]
    cfgs = [Config(hf_home=work / f"c{tag}-{i}" / "hf",
                   cache_dir=work / f"c{tag}-{i}" / "zest", endpoint=url,
                   dcn_port=0, **cfg_kw) for i in range(n)]
    # Each host's listener outlives its own pull: the peers still behind
    # it read from it until every host is done.
    shaped = {} if shaping is None else dict(
        shaping, shape_slices=cfg_kw["coop_topology"],
        shape_pods=cfg_kw["coop_pods"])
    servers = [DcnServer(c, span_attrs={"host": i}, **shaped,
                         **({"shape_host": i} if shaped else {}))
               for i, c in enumerate(cfgs)]
    addrs = {i: ("127.0.0.1", srv.start()) for i, srv in enumerate(servers)}
    results, errors = [None] * n, []

    def host(i):
        try:
            with telemetry.trace.context(host=i):
                results[i] = pull_model(
                    cfgs[i], REPO, revision=revision, device=dev, coop=True,
                    coop_hosts=n,
                    coop_index=i,
                    coop_addrs={j: a for j, a in addrs.items() if j != i},
                    coop_server=servers[i],
                    log=lambda *a, **k: print(f"  [host {i}]", *a,
                                              file=sys.stderr))
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    # Every transport the hosts' collectives build, for their counters.
    made, real_make = [], collective.make_transport

    def make_transport(*a, **k):
        made.append(real_make(*a, **k))
        return made[-1]

    counters = (blake3_cuda.COUNTER, bg4_cuda.COUNTER,
                bg4_cuda.FUSED_COUNTER)
    for c in counters:
        c.reset()  # counts from here are this path's
    threads = [threading.Thread(target=host, args=(i,)) for i in range(n)]
    collective.make_transport = make_transport
    tracer = telemetry.trace.install(None) if traced else None
    t0 = time.monotonic()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        collective.make_transport = real_make
        for srv in servers:
            srv.shutdown()
        if traced:
            telemetry.trace.uninstall()
        # In one process the hosts' pulls share the process trace
        # context; none of it may reach a later phase.
        telemetry.trace.clear_context()
    wall = time.monotonic() - t0
    launches = {name: (c.launches, c.rows) for name, c in zip(
        ("blake3_chunks", "bg4_regroup", "bg4_fused_verify"), counters)}
    if errors:
        raise errors[0]

    per_xorb = {h: bg4_chunks_of(cfg_a.xorb_cache_path(h).read_bytes())
                for h in pushed.xorb_digests}
    want_rows = (n - 1) * sum(b for b, _ in per_xorb.values())
    want_rest = (n - 1) * sum(r for _, r in per_xorb.values())
    with open(ckpt / "model.safetensors", "rb") as f:
        header_bytes = 8 + int.from_bytes(f.read(8), "little")
    probe_bound = 2 * (header_bytes + MAX_CHUNK_BYTES)
    cdn_total, probes = 0, []
    lanes = {k: sum(t.counters.get(k, 0) for t in made)
             for k in ("windows", "ici_windows", "ici_lane_bytes",
                       "lane_overflows")}
    for i, res in enumerate(results):
        st = res.stats
        c = st.get("coop")
        if not c or c.get("skipped"):
            fail(f"{label} host {i}: no cooperative round ran: "
                 f"{st.get('coop')}")
        cx = c.get("collective")
        if schedule is None and cx is not None:
            fail(f"{label} host {i}: the collective ran: {cx}")
        if schedule is not None and (
                not cx or (cx["schedule"], cx["phases"]) != (schedule, 2)
                or cx.get("aborted") is not None):
            fail(f"{label} host {i}: collective {cx}, not {schedule} in 2 "
                 "phases, unaborted")
        if cx and cx.get("backend") == "jax" and not (
                cx["link_bytes"]["ici"] > 0 and cx["link_bytes"]["dcn"] > 0):
            fail(f"{label} host {i}: link bytes {cx['link_bytes']}")
        ex = c["exchange"]
        if c["fallbacks"] or ex["verify_rejected"] or not ex["units"]:
            fail(f"{label} host {i}: fallbacks {c['fallbacks']}, rejected "
                 f"{ex['verify_rejected']}, exchanged {ex['units']}")
        if not 0 < ex["wire_bytes"] < ex["unpacked_bytes"]:
            fail(f"{label} host {i}: wire {ex['wire_bytes']} vs unpacked "
                 f"{ex['unpacked_bytes']}")
        if c["peer_served_ratio"] < 0.6 or st["fallback_files"]:
            fail(f"{label} host {i}: peer-served {c['peer_served_ratio']}, "
                 f"fallback_files {st['fallback_files']}")
        coop_cdn = (c["fetch"]["tiers"].get("cdn", 0)
                    + ex.get("fallback_tiers", {}).get("cdn", 0))
        # Outside the round, only the header probe that orders it by
        # layer may reach the CDN; the landing and the files read the
        # cache.
        probe = st["fetch"]["bytes"]["cdn"] - coop_cdn
        if not 0 < probe <= probe_bound:
            fail(f"{label} host {i}: {probe} CDN bytes outside the round (the "
                 f"header probe reads at most {probe_bound})")
        probes.append(probe)
        cdn_total += st["fetch"]["bytes"]["cdn"]
        if not st["hbm"]["direct"]:
            fail(f"{label} host {i}: the landing staged from disk")
        check_files(f"{label} host {i}", res, ckpt)
        check_tree(f"{label} host {i}", res, digest, dev)
    if cdn_total > 1.05 * pushed.new_xorb_bytes:
        fail(f"{label}: {cdn_total:,} CDN bytes over {n} hosts > 1.05 x "
             f"{pushed.new_xorb_bytes:,}")
    fu_launches, fu_rows = launches["bg4_fused_verify"]
    if fu_rows != want_rows or not fu_launches:
        fail(f"{label}: bg4_fused_verify covered {fu_rows} rows in "
             f"{fu_launches} "
             f"launches; the hosts received {want_rows} BG4 chunks")
    if launches["bg4_regroup"][0]:
        fail(f"{label}: the coop path launched the standalone regroup "
             f"{launches['bg4_regroup'][0]} times")
    if launches["blake3_chunks"][1] != want_rest:
        fail(f"{label}: blake3_chunks hashed "
             f"{launches['blake3_chunks'][1]} rows; the "
             f"hosts received {want_rest} chunks of other schemes")
    if schedule is not None and cfg_kw.get("collective_backend") == "jax" \
            and not lanes["ici_windows"]:
        fail(f"{label}: no window crossed the device lane: {lanes}")
    print(f"{label} coop pull ({card_label()}): {n} hosts in {wall:.2f} s "
          f"({', '.join(f'{k}={v}' for k, v in cfg_kw.items()) or 'defaults'}"
          f"); {cdn_total:,} CDN "
          f"bytes in all ({pushed.new_xorb_bytes:,} pushed; header probes "
          f"{probes} B); every host landed directly; "
          f"{want_rows // (n - 1)} BG4 and {want_rest // (n - 1)} other "
          f"chunks in {len(per_xorb)} xorbs, x{n - 1} receivers; launches "
          f"(rows): "
          + ", ".join(f"{k} {v[0]} ({v[1]})" for k, v in launches.items()))
    for i, res in enumerate(results):
        st, c = res.stats, res.stats["coop"]
        ex = c["exchange"]
        print(f"  host {i}: {landing_summary(st)}; coop elapsed_s "
              f"{c['elapsed_s']}, fetched "
              f"{c['fetch']['units']} units "
              f"({c['fetch']['tiers'].get('cdn', 0):,} CDN bytes), "
              f"exchanged {ex['units']} ({ex['wire_bytes']:,} wire / "
              f"{ex['unpacked_bytes']:,} unpacked bytes, {ex['retries']} "
              f"retries, peak in flight {ex['inflight_peak_bytes']:,}), "
              f"fallback {c['fallbacks']} ({ex['fallback_bytes']} bytes), "
              f"peer-served {c['peer_served_ratio']}")
        cx = c.get("collective")
        if cx:
            print(f"    collective: {cx['schedule']} {cx['phases']} phases, "
                  f"walls {cx['phase_wall_s']} s, elapsed {cx['elapsed_s']} "
                  f"s, barrier {cx['barrier_wait_s']} s, windows "
                  f"{cx['windows']} ({cx['retry_windows']} retries), links "
                  f"{cx['link_bytes']}, clock offsets "
                  f"{c.get('clock_offsets')}")
    if schedule is not None:
        print(f"  {label} transports: {lanes}")
    if shaping is not None:
        link_gates(label, work / f"c{tag}-plan", url, revision, results,
                   servers, shaping, cfg_kw["coop_topology"],
                   cfg_kw["coop_pods"], wall, launches)
    if tracer is not None:
        coop_trace_gates(label, tracer, results, fu_launches, (n - 1) * sum(
            1 for b, _ in per_xorb.values() if b))
    for i in range(n):
        shutil.rmtree(work / f"c{tag}-{i}")
    return {name: v[0] for name, v in launches.items()}


def link_gates(label: str, root: Path, url: str, revision: str, results,
               servers, shaping: dict, slices, pods, wall: float,
               launches: dict) -> None:
    """Phase 20's round over the pod map: every host's ``link_bytes``
    equal to the bytes its schedule requests over each link class, from
    the plan on the CPU (``transfer_matrix``: what the same round moves
    unshaped; shaping moves no byte elsewhere); DCN bytes on every host,
    WAN bytes on the pods' gateways and on no other host, none over ICI
    (each host its own slice); and each class's phase walls at least its
    bytes over its rate, less one burst of the serving bucket a phase."""
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.transfer import collective as coll
    from zest_tpu_torch.transfer.coop import CoopPlan

    plan = CoopPlan.build(gpt2_recs(Config(
        hf_home=root / "hf", cache_dir=root / "zest", endpoint=url),
        revision), len(results))
    shutil.rmtree(root, ignore_errors=True)
    matrix = coll.transfer_matrix(plan, slices, pods)
    gateways = set(coll.elect_gateways(plan, pods).values())
    rate = {"dcn": shaping["rate_bps"], "wan": shaping["wan_bps"]}
    burst = {"dcn": servers[0]._bucket.capacity,
             "wan": servers[0]._wan_bucket.capacity}
    totals, rows = {"ici": 0, "dcn": 0, "wan": 0}, []
    for i, res in enumerate(results):
        cx = res.stats["coop"]["collective"]
        got = cx["link_bytes"]
        want = {"ici": 0, "dcn": 0, "wan": 0}
        for src, row in enumerate(matrix):
            link = ("wan" if pods[src] != pods[i] else
                    "ici" if slices[src] == slices[i] else "dcn")
            want[link] += row[i]
        if got != want:
            fail(f"{label} host {i}: link bytes {got}, the plan's {want}")
        if not (got["dcn"] > 0 and got["ici"] == 0
                and (got["wan"] > 0) == (i in gateways)):
            fail(f"{label} host {i}: link bytes {got} (gateways "
                 f"{sorted(gateways)})")
        phases = coll.CollectiveSchedule.build(plan, i, slices,
                                               pods).phases
        for link in ("dcn", "wan"):
            walls = [w for ph, w in zip(phases, cx["phase_wall_s"])
                     if ph.link == link]
            floor = (got[link] - len(walls) * burst[link]) / rate[link]
            if sum(walls) < floor:
                fail(f"{label} host {i}: {link} phases {walls} s for "
                     f"{got[link]:,} B, below {floor:.3f} s at "
                     f"{rate[link]:,} B/s less {len(walls)} bursts")
            if got[link]:
                rows.append(f"host {i} {link} {got[link]:,} B in "
                            f"{sum(walls):.3f} s (floor {floor:.3f})")
        for k in totals:
            totals[k] += got[k]
    print(f"{label} collective over pods ({card_label()}): wall "
          f"{wall:.2f} s; slices {slices}, pods {pods}, gateways "
          f"{sorted(gateways)}; link bytes {totals} = the plan's; "
          f"shaping {shaping} (bursts {burst}); kernel launches (rows) "
          + ", ".join(f"{k} {v[0]} ({v[1]})" for k, v in launches.items())
          + "; " + "; ".join(rows))


def coop_trace_gates(label: str, tracer, results, fused_launches: int,
                     want_launches: int) -> None:
    """The traced phase 6: each host's ``stats["critical_path"]`` covers
    >= 90% of its ``time_to_hbm_s`` and its stages sum to its path within
    1 ms; the one process trace, split by host and merged, has a track a
    host, one trace id and client→server flow links, and every host's
    spans cover >= 90% of its ``coop.round``; the fused kernel ran the
    launches an untraced round runs, one per received xorb with BG4
    chunks. Every host's window holds the other hosts' spans too (one
    process, one tracer), so its split is the pod's, seen from its
    pull."""
    from zest_tpu_torch.telemetry import fleet

    n = len(results)
    doc = tracer.to_chrome()
    merged = fleet.merge_traces(fleet.split_hosts(doc, default_host=0))
    meta = merged["otherData"]
    if sorted(meta["merged_hosts"]) != [str(i) for i in range(n)]:
        fail(f"{label} traced: host tracks {meta['merged_hosts']}")
    if len(meta.get("trace_ids", ())) != 1 or meta["flow_links"] < 1:
        fail(f"{label} traced: trace ids {meta.get('trace_ids')}, "
             f"{meta['flow_links']} flow links")
    if fused_launches != want_launches:
        fail(f"{label} traced: bg4_fused_verify launched {fused_launches} "
             f"times; an untraced round launches {want_launches}")
    rows = []
    for i, res in enumerate(results):
        cp, tth = res.stats.get("critical_path"), res.stats["time_to_hbm_s"]
        if not cp or cp["path_s"] < 0.9 * tth:
            fail(f"{label} host {i}: critical path "
                 f"{cp and cp['path_s']} s < 0.9 x time_to_hbm_s {tth} s")
        split = sum(cp["stages"].values())
        if abs(split - cp["path_s"]) > 1e-3:
            fail(f"{label} host {i}: stages sum to {split:.4f} s, the path "
                 f"is {cp['path_s']} s")
        cov, root = fleet.host_coverage_s(merged, i, "coop.round")
        if not root or cov < 0.9 * root:
            fail(f"{label} host {i}: spans cover {cov:.3f} s of its "
                 f"{root:.3f} s coop.round")
        rows.append((i, tth, cp, cov, root))
    print(f"{label} traced ({card_label()}): {doc['otherData']['spans']} "
          f"spans, {n} host tracks, trace id {meta['trace_ids'][0][:12]}, "
          f"{meta['flow_links']} flow links; bg4_fused_verify "
          f"{fused_launches} launches (untraced: {want_launches})")
    for i, tth, cp, cov, root in rows:
        print(f"  host {i}: time_to_hbm_s {tth}, path {cp['path_s']} s "
              f"({cp['path_s'] / tth:.1%} of it), idle {cp['idle_s']} s, "
              f"stages {cp['stages']}, tiers {cp.get('tiers')}; coop.round "
              f"{root:.3f} s, covered {cov / root:.1%}")


def pod_phase(work: Path, url: str, ckpt: Path, pushed, cfg_a,
              digest: str, dev, revision: str) -> dict:
    """Phase 10: the pod round of ``revision`` over ``POD_SLOTS`` slots on
    ``cuda:0`` into a fresh node's ``TieredCache`` (HBM staging over the
    disk cache), then a default pull that lands from the cache; a second
    fresh node's round with one owned unit corrupted in flight. Returns
    the launch counts of the first round."""
    import torch

    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.parallel import (
        DistributionPlan,
        HbmStagingCache,
        PoolLayout,
        TieredCache,
        all_gather_throughput,
        pod_mesh,
    )
    from zest_tpu_torch.storage import XorbCache
    from zest_tpu_torch.transfer.bridge import XetBridge
    from zest_tpu_torch.transfer.pod import pod_round
    from zest_tpu_torch.transfer.pull import pull_model

    wall0 = time.monotonic()
    mesh = pod_mesh([dev] * POD_SLOTS)
    quiet = lambda *a, **k: print("  [pod]", *a, file=sys.stderr)  # noqa: E731

    def node(name: str, corrupt: str | None = None):
        cfg = Config(hf_home=work / name / "hf",
                     cache_dir=work / name / "zest", endpoint=url,
                     hbm_staging_bytes=POD_BUDGET)
        hbm = HbmStagingCache(cfg.hbm_staging_bytes, device=dev)
        bridge = XetBridge(cfg, cache=TieredCache(XorbCache(cfg), hbm))
        bridge.authenticate(REPO, revision)
        recs = [bridge.get_reconstruction(e.xet_hash)
                for e in HubClient(cfg).list_files(REPO, revision)
                if e.is_xet]
        if corrupt is not None:
            real = bridge.fetch_unit

            def fetch_unit(hash_hex, fi):
                data = real(hash_hex, fi)
                if hash_hex != corrupt:
                    return data
                bad = bytearray(data)
                bad[len(bad) // 2] ^= 0xFF
                return bytes(bad)

            bridge.fetch_unit = fetch_unit
        return cfg, hbm, bridge, recs

    cfg, hbm, bridge, recs = node("p10")
    plan = DistributionPlan.build(recs, POD_SLOTS)
    single = max(PoolLayout.from_plan(DistributionPlan(POD_SLOTS, [a]))
                 .pool_bytes for a in plan.assignments)
    per_xorb = {h: bg4_chunks_of(cfg_a.xorb_cache_path(h).read_bytes())
                for h in pushed.xorb_digests}
    counters = (blake3_cuda.COUNTER, bg4_cuda.COUNTER,
                bg4_cuda.FUSED_COUNTER)
    for c in counters:
        c.reset()  # counts from here are the pod round's
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    st = pod_round(bridge, recs, mesh=mesh, log=quiet)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {name: (c.launches, c.rows) for name, c in zip(
        ("blake3_chunks", "bg4_regroup", "bg4_fused_verify"), counters)}
    bridge.close()
    want_bg4 = sum(b for b, _ in per_xorb.values())
    want_rest = sum(r for _, r in per_xorb.values())
    if st.get("skipped") or st["filled"] != st["units"] \
            or st["verify_rejected"]:
        fail(f"phase 10: {st}")
    if st["waves"] < 2 or not (st["pool_bytes"] <= POD_BUDGET
                               or st["pool_bytes"] <= single):
        fail(f"phase 10: {st['waves']} waves, peak pool "
             f"{st['pool_bytes']:,} B over the budget {POD_BUDGET:,} B and "
             f"the single-unit bound {single:,} B")
    if launches["bg4_fused_verify"][1] != want_bg4 \
            or launches["blake3_chunks"][1] != want_rest \
            or launches["bg4_regroup"][0]:
        fail(f"phase 10: launches (rows) {launches}; the units hold "
             f"{want_bg4} BG4 and {want_rest} other chunks")
    gbps = all_gather_throughput(mesh)
    print(f"phase 10 pod round ({card_label()}): {POD_SLOTS} slots on "
          f"{dev}, budget {POD_BUDGET:,} B: {st}; single-unit pool "
          f"{single:,} B; peak allocation +{peak:,} B during the round; HBM "
          f"staging {hbm.summary()}; launches (rows): "
          + ", ".join(f"{k} {v[0]} ({v[1]})" for k, v in launches.items())
          + f"; all_gather_throughput {gbps:.1f} GB/s (64 MiB a slot)")
    del hbm, bridge

    # A default pull: the pre-pass skips on one card, the landing reads
    # the cache the round filled.
    res = pull_model(cfg, REPO, revision=revision, device=dev, log=quiet)
    pst = res.stats
    if pst["fetch"]["bytes"]["cdn"] or not pst.get("pod", {}).get("skipped"):
        fail(f"phase 10: the pull after the round: CDN "
             f"{pst['fetch']['bytes']['cdn']} B, pod {pst.get('pod')}")
    check_files("phase 10", res, ckpt)
    check_tree("phase 10", res, digest, dev)
    print(f"  phase 10 pull after the round: {landing_summary(pst)}; 0 CDN "
          f"bytes; pod {pst['pod']}; files and digest equal to phase 4's")
    del res

    # One owned unit corrupted in flight: rejected at the fill, healed by
    # the next pull from the CDN.
    victim = sorted(a.hash_hex for a in plan.assignments)[0]
    cfg2, hbm2, bridge2, recs2 = node("p10b", corrupt=victim)
    st2 = pod_round(bridge2, recs2, mesh=mesh, log=quiet)
    bridge2.close()
    del hbm2, bridge2
    if st2["verify_rejected"] != 1 or st2["filled"] != st2["units"] - 1:
        fail(f"phase 10: the corrupted unit: {st2}")
    res = pull_model(cfg2, REPO, revision=revision, device=dev, log=quiet)
    victim_bytes = next(a.est_bytes for a in plan.assignments
                        if a.hash_hex == victim)
    if res.stats["fetch"]["bytes"]["cdn"] != victim_bytes:
        fail(f"phase 10: the heal fetched {res.stats['fetch']['bytes']['cdn']}"
             f" CDN bytes, the corrupted unit is {victim_bytes}")
    check_files("phase 10 heal", res, ckpt)
    check_tree("phase 10 heal", res, digest, dev)
    print(f"  phase 10 corrupted unit {victim[:12]}: verify_rejected "
          f"{st2['verify_rejected']}, filled {st2['filled']}/{st2['units']}; "
          f"the next pull healed it with {victim_bytes:,} CDN bytes; digest "
          f"equal; phase wall {time.monotonic() - wall0:.2f} s")
    del res
    shutil.rmtree(work / "p10")
    shutil.rmtree(work / "p10b")
    return {name: v[0] for name, v in launches.items()}


class Seeder:
    """``python -m zest_tpu_torch serve`` over a node's cache, as its own
    process (an in-process seeder would share the puller's interpreter
    lock). ``stop()`` sends SIGTERM, reaps it and returns the
    ``ServerStats`` it prints; a seeder that fails to start, or dies,
    fails the phase."""

    def __init__(self, label: str, cfg, args=(), **env):
        with socket.socket() as probe:
            probe.bind(("127.0.0.1", 0))
            self.port = probe.getsockname()[1]
        child_env = {k: v for k, v in os.environ.items()
                     if k != "ZEST_FAULTS"}
        child_env.update(HF_HOME=str(cfg.hf_home),
                         ZEST_CACHE_DIR=str(cfg.cache_dir), **env)
        self.label = label
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "zest_tpu_torch", "serve",
             "--listen-port", str(self.port), "--dcn-port", "0",
             "--port", "0", *args], cwd=Path(__file__).resolve().parent,
            env=child_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        lines = []
        try:
            deadline = time.monotonic() + 120
            while not any(ln.startswith("publisher endpoint")
                          for ln in lines):
                line = self.proc.stdout.readline()
                if not line or time.monotonic() > deadline:
                    fail(f"{label}: the seeder did not start: "
                         f"{lines} {self.stderr()}")
                lines.append(line.strip())
            if not any(ln.startswith(f"seeding on :{self.port} ")
                       for ln in lines):
                fail(f"{label}: the seeder is not on port {self.port}: "
                     f"{lines}")
            self.url = lines[-1].rsplit(" ", 1)[-1]
            self.lines = lines
        except BaseException:
            self.kill()
            raise

    def stderr(self) -> str:
        self.kill()
        return self.proc.stderr.read()[-2000:]

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=30)

    def stop(self) -> dict:
        if self.proc.poll() is not None:
            fail(f"{self.label}: the seeder died (exit "
                 f"{self.proc.returncode}): {self.proc.stderr.read()[-2000:]}")
        self.proc.terminate()
        try:
            out, err = self.proc.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            self.kill()
            fail(f"{self.label}: the seeder did not stop on SIGTERM")
        stats = [ln for ln in out.splitlines()
                 if ln.startswith("seeder stats: ")]
        if self.proc.returncode != 0 or not stats:
            fail(f"{self.label}: the seeder exited {self.proc.returncode} "
                 f"without its stats: {err[-2000:]}")
        return json.loads(stats[-1][len("seeder stats: "):])


def swarm_phase(work: Path, url: str, cfg_b, ckpt: Path, pushed,
                digest: str, tth_a: float, tfl_a: float, dev) -> dict:
    """Phase 8: node B seeds its cache in its own process; fresh nodes
    pull revision A onto the card with B as their direct peer, first from
    a clean seeder (8a), then from one whose every upload is corrupt
    (8b). Returns each kernel's launches over both pulls (none expected:
    the peer tier verifies on the host)."""
    from zest_tpu_torch import storage
    from zest_tpu_torch.cas import hashing
    from zest_tpu_torch.cas.xorb import XorbReader
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    copy = pushed.new_xorb_bytes
    counters = {"blake3_chunks": blake3_cuda.COUNTER,
                "bg4_regroup": bg4_cuda.COUNTER,
                "bg4_fused_verify": bg4_cuda.FUSED_COUNTER}
    launches = dict.fromkeys(counters, 0)

    def pull_from(label: str, seeder: Seeder, node: str):
        cfg = Config(hf_home=work / node / "hf", cache_dir=work / node /
                     "zest", endpoint=url, listen_port=0)
        swarm = SwarmDownloader(cfg)
        swarm.add_direct_peer("127.0.0.1", seeder.port)
        for c in counters.values():
            c.reset()  # counts from here are this pull's
        try:
            res = pull_model(cfg, REPO, revision=pushed.revision,
                             device=dev, swarm=swarm)
        finally:
            swarm.close()
        for name, c in counters.items():
            launches[name] += c.launches
        check_files(label, res, ckpt)
        check_tree(label, res, digest, dev)
        check_direct(label, res)
        return cfg, res

    wall0 = time.monotonic()
    seeder = Seeder("phase 8a", cfg_b)
    try:
        _, res = pull_from("phase 8a", seeder, "c8")
    finally:
        served = seeder.stop()
    st, sw = res.stats, res.stats["swarm"]
    fetch = st["fetch"]
    if fetch["p2p_ratio"] < 0.9 or fetch["bytes"]["cdn"] > 0.1 * copy:
        fail(f"phase 8a: p2p_ratio {fetch['p2p_ratio']}, CDN "
             f"{fetch['bytes']['cdn']:,} B of a {copy:,} B copy: {fetch}")
    if sw["peer_failures"] or sw["corrupt_from_peer"] or             sw["health"]["quarantine_events"] or             fetch["resilience"]["corrupt_from_peer"]:
        fail(f"phase 8a: a clean seeder failed or was struck: {sw}")
    if served["chunks_served"] <= 0:
        fail(f"phase 8a: the seeder served nothing: {served}")
    print(f"phase 8a swarm pull: {landing_summary(st)}; phase 4's CDN "
          f"pull time_to_hbm_s {tth_a}, time_to_first_layer_s {tfl_a}; "
          f"p2p_ratio {fetch['p2p_ratio']}, {fetch['bytes']['peer']:,} B "
          f"from the peer in {fetch['xorbs']['peer']} fetches, "
          f"{fetch['bytes']['cdn']:,} B from the CDN; seeder served "
          f"{served['chunks_served']} chunks, {served['bytes_served']:,} B; "
          f"swarm {sw['peer_attempts']} attempts, {sw['peer_failures']} "
          f"failures; files and digest equal to phase 4's")
    del res

    seeder = Seeder("phase 8b", cfg_b, ZEST_FAULTS="upload_corrupt:1.0")
    try:
        cfg_d, res = pull_from("phase 8b", seeder, "d8")
    finally:
        served_b = seeder.stop()
    st, sw = res.stats, res.stats["swarm"]
    fetch = st["fetch"]
    if fetch["resilience"]["corrupt_from_peer"] < 1:
        fail(f"phase 8b: no corruption detected: {fetch}")
    if sw["peers_quarantined"] < 1 or sw["health"]["quarantine_events"] < 1:
        fail(f"phase 8b: the corrupting seeder was not quarantined: {sw}")
    if fetch["bytes"]["cdn"] > 1.05 * copy:
        fail(f"phase 8b: CDN {fetch['bytes']['cdn']:,} B > 1.05 x "
             f"{copy:,} B")
    cache = storage.XorbCache(cfg_d)
    full = storage.list_cached_xorbs(cfg_d)
    for key in full:
        if XorbReader(cache.get(key)).xorb_hash() != hashing.hex_to_hash(key):
            fail(f"phase 8b: a corrupt blob is cached under the full key "
                 f"{key[:16]}")
    print(f"phase 8b corrupting seeder: {landing_summary(st)}; "
          f"corrupt_from_peer {fetch['resilience']['corrupt_from_peer']}, "
          f"{sw['peers_quarantined']} quarantine trip(s), peer bytes "
          f"{fetch['bytes']['peer']:,}, CDN {fetch['bytes']['cdn']:,} B "
          f"({fetch['bytes']['cdn'] / copy:.4f} of a copy); seeder served "
          f"{served_b['chunks_served']} corrupt chunks; {len(full)} "
          f"whole-xorb entries all hash to their keys; files and digest "
          f"equal to phase 4's")
    if any(launches.values()):
        fail(f"phase 8: a kernel launched on the peer path: {launches}")
    print(f"phase 8 wall {time.monotonic() - wall0:.2f} s; kernel launches "
          f"on the peer path {launches}")
    del res
    shutil.rmtree(work / "c8")
    shutil.rmtree(work / "d8")
    return launches


class LoopbackTracker:
    """Phase 15a's BitTorrent HTTP tracker on loopback (the package has no
    tracker server, as the JAX package has none). Every ``GET /announce``
    is recorded and registers its peer (the caller's address, the query's
    port; port 0 is a lookup that registers nothing) under its info hash;
    the answer is the bencoded compact list of the hash's registered
    peers."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        from urllib.parse import unquote_to_bytes

        self.announces: list[dict] = []
        self.peers: dict[bytes, dict[tuple[str, int], None]] = {}
        lock = threading.Lock()
        tracker = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                query = dict(part.split("=", 1) for part in
                             self.path.partition("?")[2].split("&")
                             if "=" in part)
                ih = unquote_to_bytes(query.get("info_hash", ""))
                port = int(query.get("port", "0"))
                row = {"info_hash": ih,
                       "peer_id": unquote_to_bytes(query.get("peer_id", "")),
                       "port": port,
                       "uploaded": int(query.get("uploaded", "0")),
                       "event": query.get("event", "")}
                with lock:
                    tracker.announces.append(row)
                    known = tracker.peers.setdefault(ih, {})
                    if port:
                        known[(self.client_address[0], port)] = None
                    compact = b"".join(
                        socket.inet_aton(h) + p.to_bytes(2, "big")
                        for h, p in known)
                body = (b"d8:intervali60e5:peers%d:" % len(compact)
                        + compact + b"e")
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        self.url = (f"http://127.0.0.1:{self._httpd.server_address[1]}"
                    "/announce")

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=10)


def free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


class RungLog:
    """Which rung of the pull's file chain wrote each file: the cache
    lane, the ``ParallelDownloader``, the bridge's sequential
    ``reconstruct_to_file`` or the plain download, each write counted
    where the rung runs (the functions are wrapped for the ``with``
    block)."""

    def __init__(self):
        self.rows: list[tuple[str, str]] = []

    def __enter__(self):
        from zest_tpu_torch.transfer import bridge, parallel, pull

        self._saved = [
            (pull, "_write_file_from_cache", pull._write_file_from_cache),
            (parallel.ParallelDownloader, "write_plan_to_temp",
             parallel.ParallelDownloader.write_plan_to_temp),
            (bridge.XetBridge, "reconstruct_to_file",
             bridge.XetBridge.reconstruct_to_file),
            (pull.HubClient, "download_regular_file",
             pull.HubClient.download_regular_file)]
        rows = self.rows

        def wrap(rung, fn, name_of, wrote=lambda out: True):
            def counted(*args, **kw):
                out = fn(*args, **kw)
                if wrote(out):
                    rows.append((rung, name_of(args)))
                return out
            return counted

        pull._write_file_from_cache = wrap(
            "cache", pull._write_file_from_cache,
            lambda a: Path(a[2]).name, wrote=lambda out: out is not None)
        parallel.ParallelDownloader.write_plan_to_temp = wrap(
            "parallel", parallel.ParallelDownloader.write_plan_to_temp,
            lambda a: Path(a[2]).name)
        bridge.XetBridge.reconstruct_to_file = wrap(
            "sequential", bridge.XetBridge.reconstruct_to_file,
            lambda a: Path(a[2]).name)
        pull.HubClient.download_regular_file = wrap(
            "plain", pull.HubClient.download_regular_file,
            lambda a: Path(a[3]).name)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)


def discovery_phase(work: Path, url: str, cfg_b, ckpt: Path, pushed,
                    digest: str, dev) -> dict:
    """Phase 15: node B's cache seeded by its own ``serve`` process, found
    by fresh nodes through the tracker (15a), the DHT (15b) and the gossip
    plane (15c), never named as a direct peer; 15d writes every xet file
    of a files-only pull through the ``ParallelDownloader``. Returns each
    kernel's launches by path (none expected: the peer tier verifies on
    the host)."""
    from zest_tpu_torch import cli, storage
    from zest_tpu_torch.cas import hashing
    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.p2p.dht import Dht
    from zest_tpu_torch.p2p.peer_id import compute_info_hash
    from zest_tpu_torch.transfer.dcn import DcnPool
    from zest_tpu_torch.transfer.gossip import DcnGossipTransport, GossipNode
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    copy = pushed.new_xorb_bytes
    counters = {"blake3_chunks": blake3_cuda.COUNTER,
                "bg4_regroup": bg4_cuda.COUNTER,
                "bg4_fused_verify": bg4_cuda.FUSED_COUNTER}
    launches = {path: dict.fromkeys(counters, 0)
                for path in ("tracker", "dht", "gossip", "files_parallel")}
    cached = storage.list_cached_xorbs(cfg_b)
    a_keys = sorted(pushed.xorb_digests)
    a_hashes = [compute_info_hash(hashing.hex_to_hash(h)) for h in a_keys]

    def pull_on(label: str, node: str, swarm, path: str, land=True):
        cfg = Config(hf_home=work / node / "hf", cache_dir=work / node /
                     "zest", endpoint=url, listen_port=0)
        for c in counters.values():
            c.reset()  # counts from here are this pull's
        t0 = time.monotonic()
        res = pull_model(cfg, REPO, revision=pushed.revision, device=dev,
                         swarm=swarm, land=land)
        wall = time.monotonic() - t0
        for name, c in counters.items():
            launches[path][name] += c.launches
        check_files(label, res, ckpt)
        if land:
            check_tree(label, res, digest, dev)
            check_direct(label, res)
        st, sw = res.stats, res.stats["swarm"]
        fetch = st["fetch"]
        if fetch["p2p_ratio"] < 0.9 or fetch["bytes"]["cdn"] > 0.1 * copy:
            fail(f"{label}: p2p_ratio {fetch['p2p_ratio']}, CDN "
                 f"{fetch['bytes']['cdn']:,} B of a {copy:,} B copy")
        if sw["peer_failures"] or sw["corrupt_from_peer"] or \
                sw["health"]["quarantine_events"] or \
                fetch["resilience"]["corrupt_from_peer"]:
            fail(f"{label}: a clean seeder failed or was struck: {sw}")
        if sw["peers_discovered"] <= 0 or swarm.direct_peers:
            fail(f"{label}: peers_discovered {sw['peers_discovered']}, "
                 f"direct peers {swarm.direct_peers}")
        return cfg, res, wall

    def landed_line(label: str, res, wall: float, source: str) -> None:
        st, fetch = res.stats, res.stats["fetch"]
        print(f"{label}: {source}; {landing_summary(st) if 'hbm' in st else 'files only'}"
              f"; wall {wall:.2f} s; p2p_ratio {fetch['p2p_ratio']}, "
              f"{fetch['bytes']['peer']:,} B from peers, "
              f"{fetch['bytes']['cdn']:,} B from the CDN; "
              f"peers_discovered {st['swarm']['peers_discovered']}")

    wall0 = time.monotonic()
    tracker = LoopbackTracker()
    dcn_port, dead_port = free_port(), free_port()
    seeder = Seeder(
        "phase 15", cfg_b, args=("--dcn-port", str(dcn_port),
                                 "--tracker", tracker.url),
        ZEST_COOP_INDEX="0", ZEST_COOP_HOSTS="2",
        ZEST_COOP_ADDRS=f"0=127.0.0.1:{dcn_port},1=127.0.0.1:{dead_port}")
    b_addr = ("127.0.0.1", seeder.port)
    try:
        if f"indexed {len(cached)} cached xorbs" not in seeder.lines or \
                not any(ln.startswith("gossip: ") for ln in seeder.lines):
            fail(f"phase 15: the daemon did not index its cache or start "
                 f"gossip: {seeder.lines}")

        # ── 15a: the tracker ──
        t0 = time.monotonic()
        env = {k: v for k, v in os.environ.items() if k != "ZEST_FAULTS"}
        env.update(HF_HOME=str(cfg_b.hf_home),
                   ZEST_CACHE_DIR=str(cfg_b.cache_dir),
                   ZEST_LISTEN_PORT=str(seeder.port))
        seed = subprocess.run(
            [sys.executable, "-m", "zest_tpu_torch", "seed", "--tracker",
             tracker.url], cwd=Path(__file__).resolve().parent, env=env,
            capture_output=True, text=True, timeout=300)
        want = f"announced {len(cached)}/{len(cached)} xorbs to the swarm"
        if seed.returncode != 0 or want not in seed.stdout:
            fail(f"phase 15a: seed exited {seed.returncode}: "
                 f"{seed.stdout[-2000:]} {seed.stderr[-2000:]}")
        held = [h for h in cached if b_addr in tracker.peers.get(
            compute_info_hash(hashing.hex_to_hash(h)), {})]
        if len(held) != len(cached):
            fail(f"phase 15a: the tracker holds {len(held)} of "
                 f"{len(cached)} xorbs at B's port")
        seed_s = time.monotonic() - t0
        swarm_t = cli._build_swarm(Config(hf_home=work / "t15" / "hf",
                                          cache_dir=work / "t15" / "zest",
                                          listen_port=0),
                                   tracker=tracker.url, dht=False)
        try:
            if [type(s).__name__ for s in swarm_t.peer_sources] != \
                    ["TrackerClient"]:
                fail(f"phase 15a: sources {swarm_t.peer_sources}")
            _, res, wall = pull_on("phase 15a", "t15", swarm_t, "tracker")
            leecher_id = swarm_t.peer_sources[0].peer_id
            lookups = sum(a["peer_id"] == leecher_id
                          for a in tracker.announces)
            if lookups < len(a_keys):
                fail(f"phase 15a: the tracker saw {lookups} lookups of "
                     f"the leecher for {len(a_keys)} xorbs")
            landed_line("phase 15a tracker", res, wall,
                        f"seed announced {len(cached)} xorbs in "
                        f"{seed_s:.2f} s, {lookups} leecher lookups")
            del res
            shutil.rmtree(work / "t15")

            # ── 15d: the parallel rung, files only, 15a's swarm ──
            entries = HubClient(cfg_b).list_files(REPO, pushed.revision)
            xet = sorted(e.path for e in entries if e.is_xet)
            with RungLog() as rungs:
                _, res, wall = pull_on("phase 15d", "f15", swarm_t,
                                       "files_parallel", land=False)
        finally:
            swarm_t.close()
        st = res.stats
        by_file = {}
        for rung, name in rungs.rows:
            by_file.setdefault(name, []).append(rung)
        if any(by_file.get(Path(p).name) != ["parallel"] for p in xet):
            fail(f"phase 15d: rungs {by_file}, xet files {xet}")
        lanes = st["files_pipeline"]["lane_bytes"]
        total = sum(e.size for e in entries)
        if lanes != {"waterfall": total} or st["fallback_files"]:
            fail(f"phase 15d: lanes {lanes} (files {total:,} B), "
                 f"fallbacks {st['fallback_files']}")
        files_s = st["stages"]["files"]
        landed_line("phase 15d files-only", res, wall,
                    f"rungs {by_file}; files stage {files_s} s, "
                    f"{total / files_s / 1e6:.1f} MB/s")
        del res
        shutil.rmtree(work / "f15")

        # B announces A's xorbs on a push: the tracker sees B's first
        # announce per xorb with the bytes B has served, and the gossip
        # node rumors them.
        import urllib.request

        body = json.dumps({
            "repo": REPO, "revision": pushed.revision,
            "xorbs": [[h, (cfg_b.xorb_cache_path(h).stat().st_size)]
                      for h in a_keys]}).encode()
        req = urllib.request.Request(f"{seeder.url}/v1/push", data=body,
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            if not json.loads(r.read()).get("ok"):
                fail("phase 15: POST /v1/push was not ok")
        mine = [a for a in tracker.announces if a["port"] == seeder.port
                and a["event"] == "started" and a["uploaded"] > 0]
        if sorted(a["info_hash"] for a in mine) != sorted(a_hashes):
            fail(f"phase 15a: B's announces with uploaded > 0 cover "
                 f"{len(mine)} of {len(a_hashes)} pushed xorbs")
        print(f"phase 15a push: B announced {len(mine)} xorbs to the "
              f"tracker with uploaded {mine[0]['uploaded']:,} B")

        # ── 15b: the DHT ──
        router, seeder_dht, leecher_dht = (
            Dht(bind=("127.0.0.1", 0)) for _ in range(3))
        try:
            seeder_dht.bootstrap([("127.0.0.1", router.port)])
            leecher_dht.bootstrap([("127.0.0.1", router.port)])
            announcer = SwarmDownloader(
                Config(hf_home=cfg_b.hf_home, cache_dir=cfg_b.cache_dir,
                       listen_port=seeder.port), peer_sources=[seeder_dht])
            t0 = time.monotonic()
            try:
                announcer.announce_xorbs(cached)
            finally:
                announcer.close()
            announce_s = time.monotonic() - t0
            stored = sum(b_addr in router.peer_store.get(
                compute_info_hash(hashing.hex_to_hash(h)), {})
                for h in cached)
            if stored != len(cached):
                fail(f"phase 15b: the router stores {stored} of "
                     f"{len(cached)} xorbs at B's port")
            swarm_d = SwarmDownloader(
                Config(hf_home=work / "h15" / "hf", cache_dir=work / "h15"
                       / "zest", listen_port=0),
                peer_sources=[leecher_dht], own_sources=True)
            try:
                _, res, wall = pull_on("phase 15b", "h15", swarm_d, "dht")
            finally:
                swarm_d.close()
        finally:
            router.close()
            seeder_dht.close()
            leecher_dht.close()
        landed_line("phase 15b DHT", res, wall,
                    f"{stored} xorbs announced through the router in "
                    f"{announce_s:.3f} s")
        del res
        shutil.rmtree(work / "h15")

        # ── 15c: the gossip plane ──
        book = {0: ("127.0.0.1", dcn_port)}
        node = GossipNode(1, 2, book)
        pool = DcnPool()
        try:
            transport = DcnGossipTransport(pool, book)
            ticks = 0
            while ticks < 2 and any(0 not in node.who_has(ih)
                                    for ih in a_hashes):
                node.tick(transport)
                ticks += 1
            if any(0 not in node.who_has(ih) for ih in a_hashes):
                fail(f"phase 15c: after {ticks} ticks the digest names "
                     f"host 0 for {sum(0 in node.who_has(ih) for ih in a_hashes)} "
                     f"of {len(a_hashes)} xorbs")
            swarm_g = SwarmDownloader(Config(
                hf_home=work / "g15" / "hf", cache_dir=work / "g15" / "zest",
                listen_port=0))
            swarm_g.attach_gossip(node)
            try:
                if swarm_g.peer_sources != [node]:
                    fail(f"phase 15c: sources {swarm_g.peer_sources}")
                _, res, wall = pull_on("phase 15c", "g15", swarm_g,
                                       "gossip")
            finally:
                swarm_g.close()
        finally:
            pool.close()
        gsum = res.stats["swarm"]["gossip"]
        if gsum["rounds"] < 1:
            fail(f"phase 15c: gossip block {gsum}")
        landed_line("phase 15c gossip", res, wall,
                    f"{ticks} tick(s) to learn {len(a_hashes)} holders; "
                    f"gossip {gsum}")
        del res
        shutil.rmtree(work / "g15")
    finally:
        served = seeder.stop()
        tracker.close()
    if served["chunks_served"] <= 0:
        fail(f"phase 15: the seeder served nothing: {served}")
    if any(any(v.values()) for v in launches.values()):
        fail(f"phase 15: a kernel launched on a discovery path: {launches}")
    print(f"phase 15 wall {time.monotonic() - wall0:.2f} s; seeder served "
          f"{served['chunks_served']} chunks, {served['bytes_served']:,} B; "
          f"kernel launches {launches}")
    return launches


def receipt_timing(cfg_a, pushed, dev) -> None:
    """Each coop host's receipt verification without the network: host
    ``i`` verifies, through its own ``make_unit_verifier``, every minted
    xorb ``j`` with ``j % COOP_HOSTS != i`` (the 5-6 whole xorbs a host
    receives in phase 6). Timed host after host, each alone, then with
    every host's verifier in its own thread at once, as in phase 6: this
    parts the verifiers' contention with one another from the exchange's
    and the DCN servers'."""
    from zest_tpu_torch.transfer.pod import make_unit_verifier

    blobs = [(h, cfg_a.xorb_cache_path(h).read_bytes())
             for h in pushed.xorb_digests]
    sets = [[b for j, b in enumerate(blobs) if j % COOP_HOSTS != i]
            for i in range(COOP_HOSTS)]
    verifiers = [make_unit_verifier(device=dev) for _ in range(COOP_HOSTS)]

    errors = []

    def host(i, out):
        t0 = time.perf_counter()
        for h, data in sets[i]:
            if not verifiers[i](h, data):
                errors.append(f"receipt verify rejected minted xorb {h[:12]}")
        out[i] = time.perf_counter() - t0

    host(0, [0.0])  # warm-up
    alone, together = [0.0] * COOP_HOSTS, [0.0] * COOP_HOSTS
    for i in range(COOP_HOSTS):
        host(i, alone)
    threads = [threading.Thread(target=host, args=(i, together))
               for i in range(COOP_HOSTS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors or not all(together):
        fail(f"receipt timing: {errors or 'a host thread died'}")
    print(f"receipt verify without the network, per host (xorbs "
          f"{[len(s) for s in sets]}): alone "
          f"{[round(x, 3) for x in alone]} s (sum {sum(alone):.3f} s); "
          f"{COOP_HOSTS} hosts at once {[round(x, 3) for x in together]} s "
          f"(wall {wall:.3f} s)")


def time_bg4(cfg_a, pushed, dev, sass: tuple[int, int]) -> list[dict]:
    """Both BG4 kernels at the coop path's shapes: the largest minted
    xorb's BG4 chunks, staged as ``hash_planar_batch`` stages them. The
    fused kernel is timed in turns with the two-launch design it replaced
    (the regroup, then the BLAKE3 chunk kernel on its output). ``sass``
    is one compression's (ALU-pipe, FMA-pipe) instruction counts."""
    import torch

    from zest_tpu_torch.cas.compression import Scheme
    from zest_tpu_torch.cas.hashing import CHUNK_KEY
    from zest_tpu_torch.cas.xorb import XorbReader
    from zest_tpu_torch.ops import bg4, bg4_cuda, blake3_cuda

    blob = max((cfg_a.xorb_cache_path(h).read_bytes()
                for h in pushed.xorb_digests), key=len)
    reader = XorbReader(blob)
    idx = [i for i, s in enumerate(reader.chunk_schemes.tolist())
           if s == int(Scheme.BG4_LZ4)]
    sizes = [int(reader.chunk_sizes[i]) for i in idx]
    t0 = time.perf_counter()
    planar = [reader.extract_chunk_planar(i) for i in idx]
    t1 = time.perf_counter()
    words, lengths = bg4.stage_planar(planar, sizes, dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    B, W = words.shape
    cap = 4 * W
    v = bg4.FusedBg4Verifier(CHUNK_KEY, dev)
    kw, bf = v.key_words, v.base_flags

    def library():
        return words.view(torch.uint8).view(B, 4, cap // 4).transpose(
            1, 2).contiguous()

    out = bg4_cuda.launch(words)
    rg_err = max_abs_err(out, bg4.regroup_words(words))
    if rg_err or not torch.equal(out.view(torch.uint8),
                                 library().view(B, cap)):
        fail("regroup kernel != plain / library at the coop shapes")
    def fused():
        return bg4_cuda.launch_fused(words, lengths, kw, bf)

    def pair():
        return blake3_cuda.launch(bg4_cuda.launch(words), lengths, kw, bf)

    got = fused()
    fused_err = max_abs_err(got, bg4.fused_regroup_hash(words, lengths, kw,
                                                        bf))
    if fused_err or not torch.equal(got, pair()):
        fail("fused kernel != plain fused / the two-launch pair at the "
             "coop shapes")
    rg_ms = cuda_ms(lambda: bg4_cuda.launch(words), 50)
    rg_plain = cuda_ms(lambda: bg4.regroup_words(words), 3)
    rg_lib = cuda_ms(library, 50)
    turns = [cuda_ms(fn, 50) for fn in (fused, pair, pair, fused)]
    fu_ms, pair_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    fu_plain = cuda_ms(lambda: bg4.fused_regroup_hash(words, lengths, kw, bf),
                       3)
    # Regroup: it reads and writes each row's capacity once.
    rg_bytes = 2 * B * cap
    rg_bound = rg_bytes / HBM_BYTES_PER_S * 1e3
    # The fused function: its input read once up to each row's
    # length (64-byte blocks, as kernel #1 counts it) and its digests
    # written once; the operations are kernel #1's for these lengths plus
    # eight byte permutes (ALU pipe) per 16 regrouped bytes.
    lens = np.asarray(sizes, dtype=np.int64)
    fu_bytes, n_compressions = blake3_work(lens)
    permutes = 8 * int(((lens + 15) // 16).sum())
    alu, fma = sass
    fu_byte_ms = fu_bytes / HBM_BYTES_PER_S * 1e3
    fu_op_ms = op_ms(n_compressions * alu + permutes, n_compressions * fma)
    fu_src_ops = n_compressions * SOURCE_OPS_PER_COMPRESSION + permutes
    pair_floor = rg_bound + op_ms(n_compressions * alu, n_compressions * fma)
    print(f"bg4 kernels at coop shapes: {B} BG4 chunks of the largest xorb "
          f"({len(reader)} chunks), cap {cap} B, {int(lens.sum()):,} bytes; "
          f"host LZ4 planar decode {1e3 * (t1 - t0):.1f} ms, stage_planar + "
          f"H2D {1e3 * (t2 - t1):.1f} ms")
    print(f"  bg4_regroup {rg_ms:.4f} ms ({rg_bytes / rg_ms / 1e9:.3f} TB/s), "
          f"plain {rg_plain:.2f} ms, library {rg_lib:.4f} ms, bound "
          f"{rg_bound:.4f} ms (bytes: {rg_bytes:,} B)")
    print(f"  two-launch pair (bg4_regroup, then blake3_chunks) "
          f"{turns[1]:.4f} / {turns[2]:.4f} ms, its floor (regroup bytes + "
          f"BLAKE3 ops) {pair_floor:.4f} ms")
    print(f"  bg4_fused_verify (one launch) {turns[0]:.4f} / {turns[3]:.4f} "
          f"ms, {pair_ms / fu_ms:.2f}x faster than the pair; plain "
          f"{fu_plain:.2f} ms, bound {max(fu_byte_ms, fu_op_ms):.4f} ms "
          f"(bytes {fu_byte_ms:.4f}: {fu_bytes:,} B; ops {fu_op_ms:.4f}: "
          f"{n_compressions:,} compressions x ({alu} ALU + {fma} FMA) + "
          f"{permutes:,} permutes; {fu_src_ops / INT32_OPS_PER_S * 1e3:.4f} "
          f"at the source's {SOURCE_OPS_PER_COMPRESSION} per compression)")
    return [
        {"name": "bg4_regroup", "route": "cuda",
         "source": "zest_tpu_torch/csrc/bg4.cu",
         "replaces": "zest_tpu/ops/decode_pallas.py:103",
         "max_abs_err": rg_err, "ms": rg_ms, "plain_ms": rg_plain,
         "bound_ms": rg_bound, "bound_by": "bytes", "library_ms": rg_lib},
        {"name": "bg4_fused_verify", "route": "cuda",
         "source": "zest_tpu_torch/csrc/blake3.cu",
         "replaces": "zest_tpu/ops/decode_pallas.py:124",
         "max_abs_err": fused_err, "ms": fu_ms, "plain_ms": fu_plain,
         "pair_ms": pair_ms, "bound_ms": max(fu_byte_ms, fu_op_ms),
         "bound_by": "bytes" if fu_byte_ms > fu_op_ms else "operations",
         "library_ms": None},
    ]


def bf16_draws(seed: int, dev):
    """``w(*shape, one=False)``: a host bf16 tensor of N(0, 0.02) (1 +
    N(0, 0.02) with ``one``), drawn in float32 on ``dev`` from a torch
    generator seeded with ``seed`` and rounded to bf16 there (nearest
    even, as the landing's cast rounds). Drawing a GB-scale checkpoint
    on the card takes a second, against ~20 s with numpy on the host."""
    import torch

    dev = torch.device(dev)
    gen = torch.Generator(dev).manual_seed(seed)

    def w(*shape, one=False):
        v = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32).mul_(0.02)
        if one:
            v += 1.0
        return v.to(torch.bfloat16).cpu()

    return w


def llama_checkpoint(seed: int, cfg: dict, dev="cpu") -> dict:
    """HF-named bf16 Llama tensors drawn by :func:`bf16_draws` on
    ``dev``: every matrix N(0, 0.02), the norms 1 + N(0, 0.02). Tied
    embeddings: no ``lm_head.weight``."""
    E, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    qE = cfg["num_attention_heads"] * cfg["head_dim"]
    kvE = cfg["num_key_value_heads"] * cfg["head_dim"]
    w = bf16_draws(seed, dev)

    t = {"model.embed_tokens.weight": w(V, E)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = w(E, one=True)
        t[p + "self_attn.q_proj.weight"] = w(qE, E)
        t[p + "self_attn.k_proj.weight"] = w(kvE, E)
        t[p + "self_attn.v_proj.weight"] = w(kvE, E)
        t[p + "self_attn.o_proj.weight"] = w(E, qE)
        t[p + "post_attention_layernorm.weight"] = w(E, one=True)
        t[p + "mlp.gate_proj.weight"] = w(F, E)
        t[p + "mlp.up_proj.weight"] = w(F, E)
        t[p + "mlp.down_proj.weight"] = w(E, F)
    t["model.norm.weight"] = w(E, one=True)
    return t


def cached_logits(llama, params, cfg, tokens, n0: int):
    """The cached path's logits over token rows (B, T): the prompt's
    prefill window, then one cached step per position, as the decode
    runs them. Returns (B, T - 1, vocab) float32 logits on the card."""
    import torch

    from zest_tpu_torch.models.tensor_parallel import decode_fns

    init, decode_step, decode_window = decode_fns(
        params, llama.init_kv_cache, llama.decode_step, llama.decode_window)
    B, T = tokens.shape
    cache = init(cfg, B, T, dtype=params["wte"].dtype, device=tokens.device)
    logits, cache = decode_window(params, cache, tokens[:, :n0], 0, cfg)
    out = [logits.float()]
    for pos in range(n0, T - 1):
        step, cache = decode_step(params, cache, tokens[:, pos], pos, cfg)
        out.append(step[:, None].float())
    return torch.cat(out, dim=1)


def tree_map(fn, tree):
    """``fn`` over the leaves of a dict tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def top2_margin(scores) -> float:
    """The gap between the two largest of a row of scores."""
    top = scores.float().topk(2).values
    return float(top[0] - top[1])


def tokens_agree(label: str, got, want, margin_at, tol: float) -> str:
    """Card tokens ``got`` against the CPU run's ``want`` (B, T): equal,
    or each row's first difference at a position where the CPU run's
    top-2 margin (``margin_at(row, pos)``) is below ``tol``. Returns a
    note for the log."""
    notes = []
    for row, (g, w) in enumerate(zip(np.atleast_2d(got), np.atleast_2d(want))):
        diff = np.nonzero(g != w)[0]
        if diff.size == 0:
            continue
        pos = int(diff[0])
        margin = margin_at(row, pos)
        if not margin < tol:
            fail(f"{label}: row {row} differs from the CPU run at "
                 f"position {pos} (CPU top-2 margin {margin:.3e} >= {tol:.1e})")
        notes.append(f"row {row} from position {pos} (CPU top-2 margin "
                     f"{margin:.3e} < {tol:.1e})")
    return "equal" if not notes else "near-tie: " + "; ".join(notes)


def llama_reference(label: str, res, host: dict, hf_config: dict,
                    seed: int, steps: int, dev, cpu_decodes: bool = True):
    """The decode gates of a Llama landing ``res`` (its bf16 tree on the
    card; ``host`` the same checkpoint on the CPU): greedy decodes at
    batch 1 and 4 from the landed tree through ``load_generator``, the
    float32 tree's cached logits at every position within ``LOGITS_TOL``
    of the CPU's uncached float32 forward (TF32 and bf16-tree errors
    beside it, the bf16 one beyond the tolerance) and, with
    ``cpu_decodes`` (phase 7), greedy and injected-noise sampled tokens
    equal to the CPU float32 run's but for a near-tie below the
    tolerance. Returns the reference later phases hold trees of this
    checkpoint to (prompts, noise, the bf16 error, the card's tokens and
    float32 logits along them, the CPU's logits, tok/s), the generator
    and ``{"errs", "notes", "cpu_fwd_s", "cpu_decode_s"}``. The landing's
    tree is dropped."""
    import torch

    from zest_tpu_torch.models import llama
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.sampling import gumbel_noise, sample_scores

    cfg = llama.LlamaConfig.from_hf(hf_config)
    _, gen = load_generator(res.snapshot_dir, device=dev, tensors=res.params)
    params = llama.params_from_hf(res.params, cfg)  # the logits gate's
    res.params = None  # the landed bf16 tree is not kept
    params_cpu = llama.params_from_hf(host, cfg)
    rng = np.random.default_rng(seed + 8)
    prompts = rng.integers(0, cfg.vocab_size, (4, 8)).tolist()
    n0, total = 8, 8 + steps
    rates, greedy = {}, {}
    for batch in ([prompts[0]], prompts):
        gen(batch, 2, stop_at_eos=False)  # warm-up
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        out = gen(batch, steps, stop_at_eos=False)
        dt = time.monotonic() - t0
        rates[len(batch)] = len(batch) * steps / dt
        greedy[len(batch)] = np.atleast_2d(out)

    # Logits: every position of the cached path on the card against the
    # CPU's uncached float32 forward over the same rows; beside it the
    # same comparison with TF32 on, and with the tree in bf16.
    errs = {"f32": 0.0, "tf32": 0.0, "bf16": 0.0}
    cpu_logits = {}
    params_bf16 = tree_map(lambda t: t.to(torch.bfloat16), params)
    t0 = time.monotonic()
    for b, rows in greedy.items():
        toks = torch.from_numpy(rows).to(dev)
        want = llama.forward(params_cpu, toks.cpu(), cfg)[:, :total - 1]
        cpu_logits[b] = want
        for mode in errs:
            torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
            try:
                got = cached_logits(llama, params_bf16 if mode == "bf16"
                                    else params, cfg, toks, n0).cpu()
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            errs[mode] = max(errs[mode], float((got - want).abs().max()))
    del params_bf16
    cpu_fwd_s = time.monotonic() - t0
    if not errs["f32"] <= LOGITS_TOL:
        fail(f"{label}: card logits off the CPU's by {errs['f32']:.3e} > "
             f"{LOGITS_TOL:.1e}")
    if not errs["bf16"] > LOGITS_TOL:
        fail(f"{label}: a bf16 decode passes the logits tolerance "
             f"({errs['bf16']:.3e} <= {LOGITS_TOL:.1e})")

    # Greedy tokens against the CPU float32 run.
    t0 = time.monotonic()
    notes = {}
    for b, rows in greedy.items() if cpu_decodes else ():
        batch = prompts[:b]
        want = np.atleast_2d(llama.generate_cached(params_cpu, cfg, batch,
                                                   steps).numpy())
        notes[f"greedy b{b}"] = tokens_agree(
            f"{label} greedy batch {b}", rows, want,
            lambda r, pos, b=b: top2_margin(cpu_logits[b][r, pos - 1]),
            LOGITS_TOL)

    # Sampled tokens: Gumbel noise drawn once on the host, injected on
    # both sides; the margin rule on the perturbed scores, whose logits
    # error is the logits' over the temperature.
    noise = gumbel_noise((total - 1, 4, cfg.vocab_size),
                         torch.Generator().manual_seed(seed))
    sampled_tol = LOGITS_TOL / SAMPLING["temperature"]
    sampled = {}
    for b in (1, 4):
        batch = prompts[:b]
        got = sampled[b] = np.atleast_2d(gen(
            batch, steps, stop_at_eos=False, noise=noise[:, :b].to(dev),
            **SAMPLING))
        if not cpu_decodes:
            continue
        want = np.atleast_2d(llama.generate_cached(
            params_cpu, cfg, batch, steps, noise=noise[:, :b],
            **SAMPLING).numpy())

        def margin(r, pos, got=got, b=b):
            logits = llama.forward(params_cpu, torch.from_numpy(
                got[r:r + 1, :pos]), cfg)[0, -1]
            return top2_margin(sample_scores(logits, **SAMPLING)
                               + noise[pos - 1, r])

        notes[f"sampled b{b}"] = tokens_agree(f"{label} sampled batch {b}",
                                              got, want, margin, sampled_tol)
    cpu_decode_s = time.monotonic() - t0

    # What later phases hold a tree of this checkpoint to: the card's
    # float32 tokens and the float32 logits along them.
    ref = {"prompts": prompts, "noise": noise, "bf16_err": errs["bf16"],
           "greedy": greedy, "sampled": sampled, "logits": {},
           "cpu_logits": cpu_logits, "rates": rates}
    for kind, rows_by_b in (("greedy", greedy), ("sampled", sampled)):
        for b, rows in rows_by_b.items():
            ref["logits"][kind, b] = cached_logits(
                llama, params, cfg, torch.from_numpy(rows).to(dev),
                n0).cpu()
    del params, params_cpu
    return ref, gen, {"errs": errs, "notes": notes, "cpu_fwd_s": cpu_fwd_s,
                      "cpu_decode_s": cpu_decode_s}


def llama_phase(work: Path, url: str, cfg_a, seed: int, steps: int,
                dev) -> dict:
    """Phase 7: Llama-3.2-1B pushed, pulled onto the card through the
    direct streaming landing, and decoded (greedy and sampled, batch 1
    and 4) against the port's own CPU float32 run
    (:func:`llama_reference`). Returns the push's BLAKE3 kernel launches,
    its revision and the reference phases 12 and 13 hold their trees to:
    the pulled snapshot (node ``l`` stays), its digest, the prompts, the
    card's float32 tokens and their logits, the noise and the bf16 tree's
    logits error."""
    import torch

    from zest_tpu_torch import telemetry
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.ops import blake3_cuda
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    wall0 = time.monotonic()
    ckpt = work / "llama"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(LLAMA_CONFIG, indent=2))
    t0 = time.monotonic()
    tensors = llama_checkpoint(seed + 7, LLAMA_CONFIG, dev)
    n_params = sum(t.numel() for t in tensors.values())
    if len(tensors) != LLAMA_TENSORS or n_params != LLAMA_PARAMS:
        fail(f"phase 7: {len(tensors)} tensors, {n_params:,} parameters")
    write_safetensors(ckpt / "model.safetensors", tensors)
    del tensors
    made_s = time.monotonic() - t0

    # ── push: the kernel re-verifies every minted chunk ──
    blake3_cuda.COUNTER.reset()  # counts from here are the push's
    t0 = time.monotonic()
    pushed = push_checkpoint(cfg_a, LLAMA_REPO, ckpt, device=dev,
                             notify=False)
    push_s = time.monotonic() - t0
    launches = blake3_cuda.COUNTER.launches
    if launches < 1 or blake3_cuda.COUNTER.rows != pushed.minted_chunks:
        fail(f"phase 7: the push's kernel hashed {blake3_cuda.COUNTER.rows} "
             f"chunks in {launches} launches; it minted "
             f"{pushed.minted_chunks}")

    # ── pull onto the card: the direct streaming landing, traced, with a
    # time-to-HBM budget no pull meets ──
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    cfg_l = Config(hf_home=work / "l" / "hf", cache_dir=work / "l" / "zest",
                   endpoint=url, slo_tthbm_s=1e-6)
    tracer = telemetry.trace.install(None)
    try:
        res = pull_model(cfg_l, LLAMA_REPO, device=dev, no_p2p=True)
    finally:
        telemetry.trace.uninstall()
    st = res.stats
    traced = llama_trace_gates(work, tracer, st)
    if st["fallback_files"]:
        fail(f"phase 7: {st['fallback_files']} whole-file fallbacks")
    check_files("phase 7", res, ckpt)
    host = load_checkpoint(res.snapshot_dir, "cpu")
    digest = params_digest(host)
    check_tree("phase 7", res, digest, dev)
    check_direct("phase 7", res)
    if any(t.dtype != torch.bfloat16 for t in res.params.values()):
        fail("phase 7: the landed tree is not bf16")

    ref, gen, info = llama_reference("phase 7", res, host, LLAMA_CONFIG,
                                     seed, steps, dev)
    del host
    ref["snapshot"], ref["digest"] = res.snapshot_dir, digest
    prompts, rates, errs = ref["prompts"], ref["rates"], info["errs"]
    n0, total = 8, 8 + steps

    # Seeded on the card: one seed, one draw; on_token sees each
    # generated position once, in order.
    seen = []
    one = gen(prompts, steps, stop_at_eos=False, seed=seed, **SAMPLING,
              on_token=lambda pos, toks: seen.append((pos, toks.copy())))
    two = gen(prompts, steps, stop_at_eos=False, seed=seed, **SAMPLING)
    if not np.array_equal(one, two):
        fail("phase 7: two card runs with one seed differ")
    if [p for p, _ in seen] != list(range(n0, total)) or any(
            not np.array_equal(one[:, p], t) for p, t in seen):
        fail(f"phase 7: on_token saw positions {[p for p, _ in seen]}")
    peak = torch.cuda.max_memory_allocated(dev)
    del gen
    res = None
    shutil.rmtree(ckpt)
    torch.cuda.empty_cache()
    bound_ms = (LLAMA_PARAMS * 4 / HBM_BYTES_PER_S) * 1e3
    print(f"phase 7 llama: {LLAMA_REPO} at its published width and depth "
          f"({n_params:,} params, {LLAMA_TENSORS} bf16 tensors, "
          f"{pushed.total_bytes:,} bytes; made in "
          f"{made_s:.2f} s); push_s {push_s:.2f} ({pushed.new_xorbs} xorbs, "
          f"{pushed.minted_chunks} chunks, kernel launches {launches}); "
          f"{landing_summary(st)}; ring {st['hbm']['ring']}; digest equal")
    print(f"  decode: tok/s batch 1 {rates[1]:.1f}, batch 4 {rates[4]:.1f} "
          f"(8 + {steps} steps, greedy; bound at batch 1 "
          f"{bound_ms:.3f} ms/token: the float32 tree read once); "
          f"logits max |card - CPU| f32 {errs['f32']:.3e} (tolerance "
          f"{LOGITS_TOL:.1e}), TF32 {errs['tf32']:.3e}, bf16 tree "
          f"{errs['bf16']:.3e}; tokens vs CPU float32 {info['notes']}; one seed "
          f"twice on the card equal; on_token positions {n0}..{total - 1}")
    print(f"  peak allocation {peak:,} B; CPU forward "
          f"{info['cpu_fwd_s']:.2f} s, CPU decodes {info['cpu_decode_s']:.2f}"
          f" s; phase wall "
          f"{time.monotonic() - wall0:.2f} s")
    print(f"  traced: {traced}")
    ref["launches"] = launches
    ref["revision"] = pushed.revision  # phase 12b's base revision
    return ref


def pool_llama_phase(work: Path, url: str, cfg_a, seed: int, steps: int,
                     dev) -> dict:
    """Phase 9's and 11a's Llama: Llama-3.2-1B at its published width,
    depth cut to ``POOL_LAYERS`` (random bf16 from ``seed + 7``), pushed
    to node A as ``POOL_REPO`` (the BLAKE3 kernel's rows = the minted
    chunks), pulled onto the card into node ``l2`` by the direct landing
    (files, digest, direct), and held to the CPU by
    :func:`llama_reference`. Returns that reference with the snapshot,
    digest, repo, config, tree bytes and the push's kernel launches."""
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.ops import blake3_cuda
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    wall0 = time.monotonic()
    ckpt = work / "llama2"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(POOL_CONFIG, indent=2))
    tensors = llama_checkpoint(seed + 7, POOL_CONFIG, dev)
    tree = sum(t.numel() * t.element_size() for t in tensors.values())
    write_safetensors(ckpt / "model.safetensors", tensors)
    del tensors
    blake3_cuda.COUNTER.reset()  # counts from here are the push's
    t0 = time.monotonic()
    pushed = push_checkpoint(cfg_a, POOL_REPO, ckpt, device=dev,
                             notify=False)
    push_s = time.monotonic() - t0
    launches = blake3_cuda.COUNTER.launches
    if launches < 1 or blake3_cuda.COUNTER.rows != pushed.minted_chunks:
        fail(f"phase 9r: the push's kernel hashed "
             f"{blake3_cuda.COUNTER.rows} chunks; it minted "
             f"{pushed.minted_chunks}")
    cfg_l = Config(hf_home=work / "l2" / "hf",
                   cache_dir=work / "l2" / "zest", endpoint=url)
    res = pull_model(cfg_l, POOL_REPO, device=dev, no_p2p=True)
    st = res.stats
    check_files("phase 9r", res, ckpt)
    host = load_checkpoint(res.snapshot_dir, "cpu")
    digest = params_digest(host)
    check_tree("phase 9r", res, digest, dev)
    check_direct("phase 9r", res)
    # Phases 9 and 11 hold their trees to the card's float32 tokens and
    # logits; the CPU decodes are phase 7's gate.
    ref, gen, info = llama_reference("phase 9r", res, host, POOL_CONFIG,
                                     seed, steps, dev, cpu_decodes=False)
    del host, gen
    shutil.rmtree(ckpt)
    ref.update(snapshot=res.snapshot_dir, digest=digest, repo=POOL_REPO,
               config=POOL_CONFIG, tree_bytes=tree, launches=launches)
    errs, rates = info["errs"], ref["rates"]
    print(f"phase 9r llama reference ({card_label()}): {POOL_REPO}, "
          f"Llama-3.2-1B's width at {POOL_LAYERS} of 16 layers ({tree:,} "
          f"B bf16); push_s {push_s:.2f} ({pushed.minted_chunks} chunks, "
          f"kernel launches {launches}); {landing_summary(st)}; digest "
          f"equal; tok/s b1 {rates[1]:.1f}, b4 {rates[4]:.1f}; logits max "
          f"|card - CPU| f32 {errs['f32']:.3e}, TF32 {errs['tf32']:.3e}, "
          f"bf16 tree {errs['bf16']:.3e}; CPU forward "
          f"{info['cpu_fwd_s']:.2f} s; phase wall "
          f"{time.monotonic() - wall0:.2f} s")
    return ref


def stream_span_gates(label: str, spans, st: dict) -> str:
    """The stream tier in a traced pull with no swarm: one ``cdn.stream``
    span per unit the warm fetch streamed, none failed, their bytes the
    warm fetch's, and every CDN byte theirs or a header term's (the
    header prefetch's ``fetch.term`` spans). Returns the summary."""
    streams = [sp for sp in spans if sp.name == "cdn.stream"]
    sbytes = sum(sp.attrs.get("bytes", 0) for sp in streams)
    tbytes = sum(sp.attrs.get("bytes", 0) for sp in spans
                 if sp.name == "fetch.term"
                 and sp.attrs.get("source") == "cdn")
    warm = st["hbm"].get("warm") or {}
    if not streams or len(streams) != warm.get("units") or warm["failed"] \
            or sbytes != warm["bytes"] \
            or any("error" in sp.attrs for sp in streams) \
            or st["fetch"]["bytes"]["cdn"] != sbytes + tbytes:
        fail(f"{label}: {len(streams)} cdn.stream spans of {sbytes:,} B, "
             f"header terms {tbytes:,} B; warm {warm}, fetch "
             f"{st['fetch']['bytes']}")
    return (f"{len(streams)} cdn.stream spans = the warm fetch's units, "
            f"{sbytes:,} B = its bytes; CDN bytes = those + the header "
            f"terms' {tbytes:,} B")


def llama_trace_gates(work: Path, tracer, st: dict) -> str:
    """Phase 7's traced pull: the critical path covers >= 90% of
    ``time_to_hbm_s`` and its stages sum to it within 1 ms; ``analyze
    --json`` over the exported trace reproduces every stage within 1 ms;
    the ``slo_breach`` event blames the path's largest stage. Returns the
    summary line, with the traced ``time_to_hbm_s`` beside the untraced
    spread of earlier runs (``LLAMA_TTH_UNTRACED_S``): the tracer's
    cost."""
    import contextlib
    import io

    from zest_tpu_torch import cli, telemetry

    cp, tth = st.get("critical_path"), st["time_to_hbm_s"]
    if not cp or cp["path_s"] < 0.9 * tth:
        fail(f"phase 7 traced: critical path {cp and cp['path_s']} s < 0.9 "
             f"x time_to_hbm_s {tth} s")
    if abs(sum(cp["stages"].values()) - cp["path_s"]) > 1e-3:
        fail(f"phase 7 traced: stages {cp['stages']} do not sum to the "
             f"path {cp['path_s']} s")
    path = work / "llama-trace.json"
    n_spans = tracer.export(path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["analyze", str(path), "--json"])
    path.unlink()
    offline = json.loads(out.getvalue()) if rc == 0 else {}
    stages = offline.get("stages")
    if stages is None or any(
            abs(stages.get(k, 0.0) - cp["stages"].get(k, 0.0)) > 1e-3
            for k in set(stages) | set(cp["stages"])):
        fail(f"phase 7 traced: analyze --json (exit {rc}) {stages} vs the "
             f"pull's {cp['stages']}")
    top = max(cp["stages"], key=cp["stages"].get)
    breaches = [e for e in telemetry.recorder.tail()
                if e["kind"] == "slo_breach" and e.get("repo") == LLAMA_REPO]
    if not breaches or breaches[-1].get("blamed_stage") != top:
        fail(f"phase 7 traced: slo_breach {breaches[-1:]} does not blame "
             f"the largest stage {top}")
    streamed = stream_span_gates("phase 7 traced", tracer.spans(), st)
    lo, hi = LLAMA_TTH_UNTRACED_S
    return (f"{n_spans} spans; {streamed}; "
            f"time_to_hbm_s {tth} s traced (untraced "
            f"{lo}-{hi} s in earlier runs), path {cp['path_s']} s "
            f"({cp['path_s'] / tth:.1%} of it), idle {cp['idle_s']} s, "
            f"stages {cp['stages']}, tiers {cp.get('tiers')}; analyze "
            f"--json equal; slo_breach blamed {top}")


def mixtral_checkpoint(seed: int, cfg: dict, dev="cpu") -> dict:
    """HF-named bf16 Mixtral tensors, drawn as :func:`llama_checkpoint`
    draws them (untied: ``lm_head.weight``)."""
    E, F, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    D = E // cfg["num_attention_heads"]
    kvE = cfg["num_key_value_heads"] * D
    w = bf16_draws(seed, dev)

    t = {"model.embed_tokens.weight": w(V, E)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = w(E, one=True)
        t[p + "self_attn.q_proj.weight"] = w(E, E)
        t[p + "self_attn.k_proj.weight"] = w(kvE, E)
        t[p + "self_attn.v_proj.weight"] = w(kvE, E)
        t[p + "self_attn.o_proj.weight"] = w(E, E)
        t[p + "post_attention_layernorm.weight"] = w(E, one=True)
        t[p + "block_sparse_moe.gate.weight"] = w(cfg["num_local_experts"],
                                                  E)
        for x in range(cfg["num_local_experts"]):
            ep = f"{p}block_sparse_moe.experts.{x}."
            t[ep + "w1.weight"] = w(F, E)
            t[ep + "w2.weight"] = w(E, F)
            t[ep + "w3.weight"] = w(F, E)
    t["model.norm.weight"] = w(E, one=True)
    t["lm_head.weight"] = w(V, E)
    return t


def router_gaps(moe, params, cfg, tokens):
    """The float32 family path's routing margins over token rows (B, T):
    for each token, the smallest gap between a layer's 2nd and 3rd router
    logits (a bf16 error larger than it can swap an expert). Returns
    (B, T) float32 on the host."""
    import torch

    x = params["wte"][tokens]
    gap = torch.full(tokens.shape, float("inf"))
    with torch.inference_mode():
        for i in range(cfg.n_layer):
            lp = moe._layer(params, i)
            h = moe._rms_norm(x, lp["ln_attn"]["g"], cfg.rms_eps)
            x = x + moe._attention(h, lp["attn"], cfg)
            h = moe._rms_norm(x, lp["ln_moe"]["g"], cfg.rms_eps)
            top = (h @ lp["moe"]["router_w"]).float().topk(3).values
            gap = torch.minimum(gap, (top[..., 1] - top[..., 2]).cpu())
            x = x + moe._moe_block(h, lp["moe"], cfg)[0]
    return gap


def sampled_margin(logits, noise, choice: int, temperature: float,
                   top_k: int | None, top_p: float | None) -> float:
    """Twice the smallest max-abs logit error (bisected) under which a
    sampled decision of the float32 path, ``choice``, could change: its
    perturbed top-2 gap can close, or the top-k or nucleus boundary can
    move a token in or out. Scores are ``logits / temperature``; an
    error ``e`` moves a difference of two scores by at most ``2e/T`` and
    a probability by a factor within ``exp(±2e/T)``. Fails where the
    decision flips at no error at all (the gate does not reproduce the
    float32 choice) or only at the bisection floor."""
    s = logits.double().numpy() / temperature
    z = s + noise.double().numpy()
    V = s.size
    order = np.argsort(s, kind="stable")
    asc = s[order]
    k = min(top_k, V) if top_k else V

    def suffix(p):
        return np.concatenate([np.cumsum(p[order][::-1])[::-1], [0.0]])

    def flips(e: float) -> bool:
        d = 2 * e / temperature
        ahead = np.searchsorted(asc, s + d, side="right")  # surely above
        near = np.searchsorted(asc, s - d, side="left")    # maybe above
        maybe, surely = V - ahead < k, V - near - 1 < k
        if not surely[choice]:
            return True
        if top_p is not None and top_p < 1.0:
            r = np.exp(d)
            p = np.exp(s - s.max())
            # Bounds of the top-k-renormalized mass ahead of a token:
            # at least its surely-ahead tokens' share of the maybe-kept
            # set, at most its maybe-ahead tokens' share of the
            # surely-kept set.
            kept = np.where(maybe, p, 0.0)
            q = kept / max(p[surely].sum(), 1e-300)
            maybe &= suffix(kept / kept.sum())[ahead] / r < top_p
            surely &= (suffix(q)[near] - q) * r < top_p
        if not surely[choice]:
            return True
        others = maybe.copy()
        others[choice] = False
        return bool(others.any() and z[others].max() >= z[choice] - d)

    if flips(0.0):
        # The gate does not reproduce the float32 choice from its own
        # logits and noise: no error bound can forgive a difference there.
        fail(f"the float32 choice {choice} is not the gate's pick from the "
             f"recorded logits and noise (top-k {top_k}, top-p {top_p})")
    lo, hi = 0.0, 16.0
    if not flips(hi):
        return 2 * hi
    for _ in range(40):
        mid = (lo + hi) / 2
        lo, hi = (lo, mid) if flips(mid) else (mid, hi)
    if hi <= 16.0 / 2 ** 40:
        fail(f"the float32 choice {choice} flips at the bisection floor "
             f"({2 * hi:.3e}): the gate cannot tell it from a tie")
    return 2 * hi


def tokens_near(label: str, got, want, margin_at, tol: float) -> tuple:
    """Pool tokens ``got`` against the float32 path's ``want`` (B, T):
    equal, or each row's first difference where ``margin_at(row, pos)``
    (the float32 run's own margin there) is below ``tol``. Returns
    ``(note, positions compared)``."""
    notes, compared = [], 0
    for row, (g, w) in enumerate(zip(np.atleast_2d(got),
                                     np.atleast_2d(want))):
        diff = np.nonzero(g != w)[0]
        if diff.size == 0:
            compared += len(g)
            continue
        pos = int(diff[0])
        compared += pos + 1
        margin = margin_at(row, pos)
        if not margin < tol:
            fail(f"{label}: row {row} differs from the float32 "
                 f"path at position {pos} (its margin {margin:.3e} >= "
                 f"{tol:.3e})")
        notes.append(f"row {row} from position {pos} (margin "
                     f"{margin:.3e} < {tol:.3e})")
    return ("equal" if not notes else "near-tie: " + "; ".join(notes),
            compared)


def pool_phase(work: Path, url: str, cfg_a, ref: dict, seed: int,
               steps: int, dev) -> dict:
    """Phase 9a: an ``HbmPool`` on the card in this process, over fresh
    node pulls: Llama-3.2-1B's width at ``POOL_LAYERS`` layers from phase
    9r's snapshot (``ref``: cold, hot, evicted, re-landed) and
    Mixtral-8x7B at its published width, cut to one layer (pushed here;
    dense core landed, experts paged). Returns the pool's tokens, the
    Mixtral push's kernel launches and this path's launches."""
    import dataclasses
    import gc

    import torch

    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models import hbm_pool, moe
    from zest_tpu_torch.models.loader import load_checkpoint
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    wall0 = time.monotonic()
    card = card_label()
    counters = (blake3_cuda.COUNTER, bg4_cuda.COUNTER,
                bg4_cuda.FUSED_COUNTER)
    for c in counters:
        c.reset()  # counts from here are the serving path's
    n0, total = 8, 8 + steps
    prompts = ref["prompts"]
    # A decision flips only where the float32 path's own margin is below
    # twice the bf16 tree's logits error (phase 9r's).
    tol = 2 * ref["bf16_err"]
    cfg_p = Config(hf_home=work / "p" / "hf", cache_dir=work / "p" / "zest",
                   endpoint=url)
    pool = hbm_pool.HbmPool(cfg_p, dev)
    snap = ref["snapshot"]
    out = {}

    # ── Llama-3.2-1B: cold (decode from the first-layer commit), hot ──
    t0 = time.monotonic()
    got, info = pool.generate_for(snap, ref["repo"], [prompts[0]], steps,
                                  stop_at_eos=False)
    cold_s = time.monotonic() - t0
    entry = pool._entries[str(Path(snap).resolve())]
    if info["temp"] != "cold" or not info["decode_start_before_land_end"] \
            or not entry.t_first_layer < entry.t_land_end:
        fail(f"phase 9a: llama cold {info}, first layer "
             f"{entry.t_first_layer} land end {entry.t_land_end}")
    land_s = entry.t_land_end - entry.t_land_start
    if pool.digest(snap) != ref["digest"]:
        fail("phase 9a: the pool's llama digest != phase 9r's landing")
    if any(t.dtype != torch.bfloat16 for t in entry.params.values()):
        fail("phase 9a: the pool's llama tree is not bf16")
    cold_ids = np.atleast_2d(got)
    notes, compared = {}, 0
    runs = {}
    for kind in ("greedy", "sampled"):
        for b in (1, 4):
            kw = {}
            if kind == "sampled":
                kw = dict(SAMPLING, noise=ref["noise"][:, :b])
            t0 = time.monotonic()
            ids, info_b = pool.generate_for(snap, ref["repo"], prompts[:b],
                                            steps, stop_at_eos=False, **kw)
            runs[kind, b] = (time.monotonic() - t0, info_b)
            ids = np.atleast_2d(ids)
            out["llama", kind, b] = ids
            logits = ref["logits"][kind, b]
            if kind == "greedy":
                def margin(r, pos, logits=logits):
                    return top2_margin(logits[r, pos - 1])
            else:
                def margin(r, pos, logits=logits, b=b):
                    return sampled_margin(
                        logits[r, pos - 1], ref["noise"][pos - 1, r],
                        int(ref["sampled"][b][r, pos]), **SAMPLING)
            notes[kind, b], n = tokens_near(
                f"phase 9 llama {kind} batch {b}", ids, ref[kind][b], margin,
                tol)
            compared += n
    if not np.array_equal(cold_ids, out["llama", "greedy", 1]):
        fail("phase 9a: the cold and hot llama runs differ")
    if runs["greedy", 1][1]["temp"] != "hot":
        fail(f"phase 9a: a second request ran {runs['greedy', 1][1]}")

    # ── evict: the memory goes back; a re-land is the same tree ──
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    if not pool.evict(snap):
        fail("phase 9a: the llama tree was not evictable")
    gc.collect()
    freed = before - torch.cuda.memory_allocated(dev)
    if freed < ref["tree_bytes"]:
        fail(f"phase 9a: evict freed {freed:,} B < {ref['tree_bytes']:,} B")
    t0 = time.monotonic()
    again, info_r = pool.generate_for(snap, ref["repo"], [prompts[0]], steps,
                                      stop_at_eos=False)
    reland_s = time.monotonic() - t0
    if info_r["temp"] != "cold" or pool.digest(snap) != ref["digest"]:
        fail(f"phase 9a: the re-land {info_r} or its digest is off")
    if not np.array_equal(np.atleast_2d(again), cold_ids):
        fail("phase 9a: the re-land's tokens differ from the cold run's")
    out["llama_cold"] = cold_ids
    pool.evict(snap)
    print(f"phase 9a pool llama ({card}): cold ttft {info['ttft_s']} s "
          f"(request {cold_s:.3f} s, land {land_s:.3f} s, first layer "
          f"{entry.t_first_layer - entry.t_land_start:.3f} s, decode from "
          f"the first-layer commit), hot ttft "
          f"{runs['greedy', 1][1]['ttft_s']} s, re-land ttft "
          f"{info_r['ttft_s']} s (request {reland_s:.3f} s); gate_stall_s "
          f"{entry.gate_stall_s:.4f}; tok/s "
          + ", ".join(f"{k} b{b} {b * steps / dt:.1f}"
                      for (k, b), (dt, _) in runs.items())
          + f"; evict freed {freed:,} B; digest = phase 9r's before and "
          f"after the re-land; tokens vs the float32 path {notes} "
          f"({compared} positions; a difference is forgiven where the "
          f"float32 decision's margin, twice the logit error that can flip "
          f"it, is below {tol:.4f} = 2 x phase 9r's bf16 logits error); "
          f"re-land tokens bit-equal to the cold run's")
    # Node l stays: phase 12b delta-pulls its fine-tune there.

    # ── Mixtral-8x7B, one layer: push, pull, pool (paged experts) ──
    ckpt = work / "mixtral"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(MIXTRAL_CONFIG, indent=2))
    t0 = time.monotonic()
    tensors = mixtral_checkpoint(seed + 9, MIXTRAL_CONFIG, dev)
    n_params = sum(t.numel() for t in tensors.values())
    if n_params != MIXTRAL_PARAMS:
        fail(f"phase 9: {n_params:,} Mixtral parameters")
    write_safetensors(ckpt / "model.safetensors", tensors)
    del tensors
    made_s = time.monotonic() - t0
    serve_launches = [c.launches for c in counters]
    blake3_cuda.COUNTER.reset()
    t0 = time.monotonic()
    pushed = push_checkpoint(cfg_a, MIXTRAL_REPO, ckpt, device=dev,
                             notify=False)
    push_s = time.monotonic() - t0
    push_launches = blake3_cuda.COUNTER.launches
    if push_launches < 1 or blake3_cuda.COUNTER.rows != pushed.minted_chunks:
        fail(f"phase 9: the push's kernel hashed {blake3_cuda.COUNTER.rows}"
             f" chunks; it minted {pushed.minted_chunks}")
    for c in counters:
        c.reset()
    t0 = time.monotonic()
    res = pull_model(cfg_p, MIXTRAL_REPO, device=dev, land=False)
    pull_s = time.monotonic() - t0
    check_files("phase 9a", res, ckpt)
    msnap = res.snapshot_dir
    mcfg = moe.MoEConfig.from_hf(MIXTRAL_CONFIG)
    mprompt = [t % mcfg.vocab_size for t in prompts[0]]
    t0 = time.monotonic()
    mids, minfo = pool.generate_for(msnap, MIXTRAL_REPO, [mprompt],
                                    steps, stop_at_eos=False)
    m_s = time.monotonic() - t0
    mentry = pool._entries[str(Path(msnap).resolve())]
    ex = minfo["experts"]
    group = MIXTRAL_EXPERT_BYTES // 8
    if (mentry.reserved != MIXTRAL_DENSE_BYTES
            or mentry.bytes != MIXTRAL_DENSE_BYTES):
        fail(f"phase 9a: mixtral reserved {mentry.reserved:,}, committed "
             f"{mentry.bytes:,} B")
    if not (ex["page_ins"] > 0 and ex["verified"] == 3 * ex["page_ins"]
            and ex["evictions"] > 0 and ex["residency"] < 0.5
            and ex["peak_bytes"] <= max(ex["budget_bytes"], group)
            and ex["budget_bytes"] == MIXTRAL_PAGER_BYTES
            and ex["total_expert_bytes"] == MIXTRAL_EXPERT_BYTES):
        fail(f"phase 9a: pager {ex}")
    mids = np.atleast_2d(mids)
    dense = mentry.bytes
    # One page-in by its parts: the host read, its BLAKE3, the commit.
    from zest_tpu_torch.cas import hashing
    from zest_tpu_torch.models import loader
    from zest_tpu_torch.models.safetensors_io import tensor_bytes

    t0 = time.monotonic()
    page = {leaf: mentry.pager._reader(name)
            for leaf, name in mentry.pager._names(0, 0).items()}
    t1 = time.monotonic()
    for view in page.values():
        hashing.blake3_hash(tensor_bytes(view).tobytes())
    t2 = time.monotonic()
    page = loader.commit_tensors(page, dev)
    page_s = (t1 - t0, t2 - t1, time.monotonic() - t2)
    del page
    out["mixtral"] = mids
    out["mixtral_prompt"] = mprompt

    # The family path: a float32 tree on the card whose capacity drops
    # nothing, held to the CPU's float32 forward at every position.
    fcfg = dataclasses.replace(mcfg, capacity_factor=mcfg.n_experts
                               / mcfg.top_k)
    host = load_checkpoint(msnap, "cpu")
    params = moe.params_from_hf({n: t.to(dev) for n, t in host.items()},
                                fcfg)
    want = np.atleast_2d(moe.generate_cached(params, fcfg, [mprompt],
                                             steps).cpu().numpy())
    toks = torch.from_numpy(want).to(dev)
    cache = moe.init_kv_cache(fcfg, 1, total, device=dev)
    logits, cache = moe.decode_window(params, cache, toks[:, :n0], 0, fcfg)
    parts = [logits.float()]
    for pos in range(n0, total - 1):
        step, cache = moe.decode_step(params, cache, toks[:, pos], pos,
                                      fcfg)
        parts.append(step[:, None].float())
    card_logits = torch.cat(parts, dim=1).cpu()
    gaps = router_gaps(moe, params, fcfg, toks[:, :total - 1])
    del params, cache
    t0 = time.monotonic()
    params_cpu = moe.params_from_hf(host, fcfg)
    del host
    cpu_logits = moe.forward(params_cpu, toks[:, :total - 1].cpu(),
                             fcfg)[0]
    cpu_fwd_s = time.monotonic() - t0
    del params_cpu
    err = float((card_logits - cpu_logits).abs().max())
    if not err <= LOGITS_TOL:
        fail(f"phase 9a: mixtral family logits off the CPU's by {err:.3e} "
             f"> {LOGITS_TOL:.1e}")

    def mmargin(r, pos):
        return min(top2_margin(card_logits[r, pos - 1]),
                   float(gaps[r, :pos].min()))

    mnote, mcompared = tokens_near("phase 9 mixtral greedy batch 1", mids,
                                   want, mmargin, tol)
    out["mixtral_family"] = (want, mmargin, tol)
    pool.close()
    torch.cuda.empty_cache()
    launches = {name: n + c.launches for name, c, n in zip(
        ("blake3_chunks", "bg4_regroup", "bg4_fused_verify"), counters,
        serve_launches)}
    print(f"phase 9a pool mixtral ({card}): {MIXTRAL_REPO} at its published "
          f"width, 1 of 32 layers ({n_params:,} params, "
          f"{pushed.total_bytes:,} bytes; made in {made_s:.2f} s); push_s "
          f"{push_s:.2f} ({pushed.new_xorbs} xorbs, {pushed.minted_chunks} "
          f"chunks, kernel launches {push_launches}); files-only pull "
          f"{pull_s:.2f} s; cold ttft {minfo['ttft_s']} s (request "
          f"{m_s:.3f} s, "
          f"{(steps - 1) / (m_s - minfo['ttft_s']):.2f} tok/s after "
          f"the first); dense core {dense:,} B committed; one page-in "
          f"(352,321,536 B): read {page_s[0]:.3f} s, BLAKE3 "
          f"{page_s[1]:.3f} s, commit {page_s[2]:.3f} s; pager "
          f"{ex}; tokens vs the float32 family path {mnote} ({mcompared} "
          f"positions, tolerance {tol:.4f}); family logits max |card - "
          f"CPU| {err:.3e} (tolerance {LOGITS_TOL:.1e}; CPU forward "
          f"{cpu_fwd_s:.2f} s); kernel launches on the serving path "
          f"{launches}; phase wall {time.monotonic() - wall0:.2f} s")
    shutil.rmtree(ckpt)
    shutil.rmtree(work / "p")
    out["push_launches"] = push_launches
    out["llama_push"] = ref["launches"]  # phase 9r's push
    out["launches"] = launches
    return out


def sse_post(url: str, body: dict) -> list[tuple[float, dict]]:
    """POST /v1/generate; returns its SSE events, each with the seconds
    from the request to its arrival (the daemon flushes each event as it
    happens)."""
    import urllib.request

    req = urllib.request.Request(
        url + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.monotonic()
    events = []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if line.startswith(b"data: "):
                events.append((time.monotonic() - t0,
                               json.loads(line[len(b"data: "):])))
    return events


def daemon_phase(work: Path, url: str, pool_out: dict, llama_repo: str,
                 llama_prompt, gpt2_b1, gpt2_sha: str, steps: int) -> dict:
    """Phase 9b: ``python -m zest_tpu_torch serve`` as its own process on
    a fresh node C whose hub is node A's publisher, with a 2 GiB pool:
    five generate requests (Llama cold, streamed hot, Mixtral cold
    evicting Llama, Llama re-landed, GPT-2 on the single-model path),
    then its metrics, status and a SIGTERM. Returns the daemon's kernel
    launches over the five requests, by kernel, from its ``/v1/status``
    before the first and after the last."""
    import urllib.request

    from zest_tpu_torch.config import Config

    wall0 = time.monotonic()
    cfg_c = Config(hf_home=work / "c9" / "hf",
                   cache_dir=work / "c9" / "zest")
    daemon = Seeder("phase 9b", cfg_c, args=("--device", "cuda"),
                    HF_ENDPOINT=url, ZEST_HBM_POOL_BYTES=str(DAEMON_POOL))
    lines = []
    try:
        def kernel_counts() -> dict:
            return json.loads(urllib.request.urlopen(
                daemon.url + "/v1/status", timeout=60).read())["kernels"]

        counts0 = kernel_counts()
        body = {"ids": list(llama_prompt), "steps": steps,
                "stop_at_eos": False}

        def ask(label, repo, stream=False, **extra):
            timed = sse_post(daemon.url, {"repo_id": repo, **body,
                                          "stream": stream, **extra})
            kinds = [e["event"] for _, e in timed]
            want = (["start", "pulled"] + ["token"] * (steps if stream
                                                       else 0) + ["done"])
            if kinds != want:
                fail(f"phase 9b {label}: events {kinds}: {timed[-1]}")
            (_, _), (t_pulled, _), *_, (t_done, done) = timed
            pool = done.get("pool")
            # The decode after its first token (the pool's TTFT runs from
            # the pool call, right after the pull): steps - 1 tokens.
            dt = t_done - t_pulled - (pool["ttft_s"] if pool else 0.0)
            lines.append(f"{label}: pull {t_pulled:.3f} s, "
                         + (f"ttft {pool['ttft_s']} s ({pool['temp']}), "
                            f"gate_stall_s {pool['gate_stall_s']}, "
                            f"{(steps - 1) / dt:.1f} tok/s after the first"
                            if pool else f"load + decode {dt:.3f} s "
                            "(single-model path)")
                         + f", wall {t_done:.3f} s")
            return done

        d1 = ask("1 llama", llama_repo)
        if d1["pool"]["temp"] != "cold" or \
                d1["ids"] != pool_out["llama_cold"][0].tolist():
            fail(f"phase 9b 1: {d1['pool']}, ids equal to 9a: "
                 f"{d1['ids'] == pool_out['llama_cold'][0].tolist()}")
        d2 = ask("2 llama streamed", llama_repo, stream=True)
        if d2["pool"]["temp"] != "hot" or d2["ids"] != d1["ids"]:
            fail(f"phase 9b 2: {d2['pool']}")
        d3 = ask("3 mixtral", MIXTRAL_REPO, ids=pool_out["mixtral_prompt"])
        ex = d3["pool"]["experts"]
        resident = json.loads(urllib.request.urlopen(
            daemon.url + "/v1/models", timeout=60).read())["resident"]
        if d3["pool"]["temp"] != "cold" or not ex["residency"] < 0.5 or \
                [r["repo"] for r in resident] != [MIXTRAL_REPO] or \
                d3["ids"] != pool_out["mixtral"][0].tolist():
            fail(f"phase 9b 3: {d3['pool']}, resident {resident}, ids "
                 f"equal to 9a: "
                 f"{d3['ids'] == pool_out['mixtral'][0].tolist()}")
        lines.append(f"  pager {ex}; resident after: "
                     f"{[(r['repo'], r['bytes']) for r in resident]}")
        d4 = ask("4 llama again", llama_repo)
        if d4["pool"]["temp"] != "cold" or d4["ids"] != d1["ids"]:
            fail(f"phase 9b 4: {d4['pool']}")
        d5 = ask("5 gpt2", REPO, revision=gpt2_sha,
                 ids=list(gpt2_b1[0]))
        if "pool" in d5 or d5["ids"] != list(gpt2_b1[1]):
            fail(f"phase 9b 5: {d5}")
        metrics = urllib.request.urlopen(daemon.url + "/v1/metrics",
                                         timeout=60).read().decode()
        status = json.loads(urllib.request.urlopen(
            daemon.url + "/v1/status", timeout=60).read())
        launches = {name: c["launches"] - counts0[name]["launches"]
                    for name, c in status["kernels"].items()}
        evictions = sum(float(ln.rsplit(" ", 1)[1]) for ln in
                        metrics.splitlines() if ln.startswith(
                            "zest_hbm_pool_evictions_total{"))
        if not ('zest_ttft_seconds_count{temp="cold"}' in metrics
                and 'zest_ttft_seconds_count{temp="hot"}' in metrics
                and evictions >= 1 and "hbm_pool" in status):
            fail(f"phase 9b: metrics/status: evictions {evictions}, "
                 f"{sorted(status)}")
    finally:
        daemon.stop()
    pool = status["hbm_pool"]
    print(f"phase 9b daemon ({card_label()}): 5 requests over HTTP (pool "
          f"watermark "
          f"{DAEMON_POOL:,} B); " + "; ".join(lines)
          + f"; pool evictions {pool['evictions']}, hits {pool['hits']}, "
          f"misses {pool['misses']}, gate_stall_s {pool['gate_stall_s']}; "
          f"kernel launches in the daemon over the five requests "
          f"{launches}; SIGTERM exit 0; phase wall "
          f"{time.monotonic() - wall0:.2f} s")
    shutil.rmtree(work / "c9")
    return launches


def mesh_phase(work: Path, url: str, cfg_a, llama_ref: dict,
               pool_out: dict, steps: int, dev) -> dict:
    """Phase 11: the mesh landing and the tensor-parallel decode on four
    slots of ``cuda:0``. 11a: Llama-3.2-1B's width at ``POOL_LAYERS``
    layers (phase 9r's push, ``llama_ref``) pulled over ``{"model": 4}``:
    every shard byte-equal to the same slice of the file's tensor, the
    digest phase 9r's, the peak allocation rise within the landed bytes
    and one commit group; float32 tensor-parallel greedy and
    injected-noise sampled decodes at batch 1 and 4 held to phase 9r
    (logits to the CPU's forward within ``LOGITS_TOL``, tokens equal but
    for a printed near-tie). 11b: Mixtral (phase 9's push) pulled over
    ``{"expert": 4}`` through the expert-routed pod round (its shared
    units verified by kernels #3 and #1 as the routed plan predicts); a
    bf16 greedy decode from that landing in place (every slot its columns
    of every expert, no expert byte gathered), then
    ``land_moe_expert_sharded`` (slot ``s`` holds experts ``2s, 2s+1``
    byte-equal to the file's) and an expert-parallel bf16 greedy decode,
    both held to phase 9's float32 family tokens by the margin rule. Returns
    the kernels' launches on this phase's path."""
    import torch

    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models import llama, moe
    from zest_tpu_torch.models import tensor_parallel as tp
    from zest_tpu_torch.models.direct import land_moe_expert_sharded
    from zest_tpu_torch.models.loader import (
        _STREAM_COMMIT_BYTES,
        load_checkpoint,
        params_digest,
    )
    from zest_tpu_torch.models.sampling import sample_scores
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.parallel.expert import (
        ExpertPlacement,
        ExpertRoutedPlan,
        classify_file,
    )
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.transfer.bridge import XetBridge
    from zest_tpu_torch.transfer.pod import fetch_file_header
    from zest_tpu_torch.transfer.pull import pull_model

    wall0 = time.monotonic()
    card = card_label()
    n0, total = 8, 8 + steps

    def int_view(t):
        return t.contiguous().view(torch.int16)

    # ── 11a: Llama-3.2-1B's width, POOL_LAYERS deep, over {"model": 4} ──
    mesh = model_mesh({"model": 4}, [dev] * 4)
    cfg_m = Config(hf_home=work / "m" / "hf", cache_dir=work / "m" / "zest",
                   endpoint=url)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    res = pull_model(cfg_m, llama_ref["repo"], device=dev, mesh=mesh,
                     pod=False)
    torch.cuda.synchronize(dev)
    rise = torch.cuda.max_memory_allocated(dev) - base
    st = res.stats
    hbm = st["hbm"]
    if not hbm["sharded"] or st["mesh"] != {"model": 4}:
        fail(f"phase 11a: sharded {hbm['sharded']}, mesh {st.get('mesh')}")
    check_direct("phase 11a", res)
    # Phase 5b's rule: beside the shards, at most one commit group (the
    # commit size, or one larger tensor alone) is held at a time.
    landed = hbm["bytes"]
    biggest = max(int(t.nbytes) for t in res.params.values())
    allowed = landed + max(_STREAM_COMMIT_BYTES, biggest)
    if rise > allowed:
        fail(f"phase 11a: the peak allocation rose {rise:,} B, above the "
             f"landed {landed:,} B and one commit group")
    host = load_checkpoint(res.snapshot_dir, "cpu")
    t0 = time.monotonic()
    for name, sh in res.params.items():
        for slot in range(4):
            got = sh.shard(slot)
            if got.device != dev or not torch.equal(
                    int_view(got.cpu()), int_view(host[name][sh.index(slot)])):
                fail(f"phase 11a: slot {slot}'s shard of {name} differs "
                     "from the file's slice")
    del host
    cmp_s = time.monotonic() - t0
    if params_digest(res.params) != llama_ref["digest"]:
        fail("phase 11a: the sharded tree's digest != phase 9r's")
    specs = {str(tuple(t.spec)) for t in res.params.values()}

    cfg = llama.LlamaConfig.from_hf(llama_ref["config"])
    t0 = time.monotonic()
    train = llama.params_from_hf(res.params, cfg)
    res.params = None  # the float32 tree holds its own casts
    params = tp.decode_params(train, cfg)
    build_s = time.monotonic() - t0
    q_w = train["blocks"]["attn"]["q_w"]
    if not isinstance(params, tp.TPParams) or any(
            params.local[j]["attn"]["q_w"].data_ptr()
            != q_w.shard(s).data_ptr()
            for j, s in enumerate(params.group.slots)):
        fail("phase 11a: the decode tree is not the tensor-parallel tree "
             "of params_from_hf's sharded tree")
    del train, q_w
    prompts = llama_ref["prompts"]
    rates, notes, errs = {}, {}, {}
    tol = 2 * LOGITS_TOL  # the TP logits' error plus phase 9r's
    for b in (1, 4):
        batch = prompts[:b]
        llama.generate_cached(params, cfg, batch, 2)  # warm-up
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        got = np.atleast_2d(llama.generate_cached(params, cfg, batch,
                                                  steps).cpu().numpy())
        rates[b] = b * steps / (time.monotonic() - t0)
        card_logits = llama_ref["logits"]["greedy", b]
        notes[f"greedy b{b}"] = tokens_agree(
            f"phase 11a greedy batch {b}", got, llama_ref["greedy"][b],
            lambda r, pos, lg=card_logits: top2_margin(lg[r, pos - 1]), tol)
        rows = torch.from_numpy(llama_ref["greedy"][b]).to(dev)
        tp_logits = cached_logits(llama, params, cfg, rows, n0).cpu()
        errs[b] = float((tp_logits - llama_ref["cpu_logits"][b]).abs().max())
        if not errs[b] <= LOGITS_TOL:
            fail(f"phase 11a: tensor-parallel logits off the CPU's by "
                 f"{errs[b]:.3e} > {LOGITS_TOL:.1e} (batch {b})")
        noise = llama_ref["noise"][:, :b]
        sampled = np.atleast_2d(llama.generate_cached(
            params, cfg, batch, steps, noise=noise.to(dev),
            **SAMPLING).cpu().numpy())
        slog = llama_ref["logits"]["sampled", b]

        def smargin(r, pos, slog=slog, noise=noise):
            return top2_margin(sample_scores(slog[r, pos - 1], **SAMPLING)
                               + noise[pos - 1, r])

        notes[f"sampled b{b}"] = tokens_agree(
            f"phase 11a sampled batch {b}", sampled,
            llama_ref["sampled"][b], smargin, tol / SAMPLING["temperature"])
    gather = params.gather_bytes
    del params
    torch.cuda.empty_cache()
    print(f"phase 11a mesh llama ({card}): {llama_ref['repo']} over "
          f"{{'model': 4}} on [{dev}] * 4: {landing_summary(st)}; sharded, "
          f"specs {sorted(specs)}; peak allocation rise {rise:,} B (landed "
          f"{landed:,} B, allowed {allowed:,}); every shard byte-equal to "
          f"the file's slice ({cmp_s:.2f} s), digest = phase 9r's; "
          f"the sharded float32 tree and its tensor-parallel decode tree "
          f"built in {build_s:.2f} s (the decode tree gathered "
          f"{gather:,} B: the head, tied here); tok/s tensor-parallel "
          f"b1 {rates[1]:.1f}, b4 {rates[4]:.1f} against unsharded "
          f"(phase 9r, same card) b1 {llama_ref['rates'][1]:.1f}, b4 "
          f"{llama_ref['rates'][4]:.1f}; logits max |TP - CPU| b1 "
          f"{errs[1]:.3e}, b4 {errs[4]:.3e} (tolerance {LOGITS_TOL:.1e}); "
          f"tokens vs phase 9r {notes}")

    # ── 11b: Mixtral over {"expert": 4}: the expert-routed round ──
    mesh = model_mesh({"expert": 4}, [dev] * 4)
    cfg_x = Config(hf_home=work / "x" / "hf", cache_dir=work / "x" / "zest",
                   endpoint=url)
    counters = (blake3_cuda.COUNTER, bg4_cuda.COUNTER,
                bg4_cuda.FUSED_COUNTER)
    for c in counters:
        c.reset()  # counts from here are phase 11b's pull
    t0 = time.monotonic()
    res = pull_model(cfg_x, MIXTRAL_REPO, device=dev, mesh=mesh, pod=True)
    pull_s = time.monotonic() - t0
    torch.cuda.synchronize(dev)
    launches = {name: (c.launches, c.rows) for name, c in zip(
        ("blake3_chunks", "bg4_regroup", "bg4_fused_verify"), counters)}
    st = res.stats
    pod = st.get("pod") or {}
    bridge = XetBridge(cfg_x)
    bridge.authenticate(MIXTRAL_REPO)
    entry = next(e for e in HubClient(cfg_x).list_files(MIXTRAL_REPO)
                 if e.path.endswith(".safetensors"))
    rec = bridge.get_reconstruction(entry.xet_hash)
    header = fetch_file_header(bridge, rec)
    placement = ExpertPlacement(8, 4)
    routed = ExpertRoutedPlan.build(
        [classify_file(rec, header, moe.expert_of_tensor)], placement)
    summary = routed.summary()
    if not (pod.get("expert_routed") and pod.get("n_experts") == 8
            and pod["expert_units_fetched"] == summary["expert_units"]
            and pod["expert_units_failed"] == 0
            and pod["ici_bytes_saved"] == summary["ici_bytes_saved"] > 0):
        fail(f"phase 11b: pod {pod}, routed plan {summary}")
    shared = pod["shared"]
    if shared.get("skipped") or shared["filled"] != shared["units"] \
            or shared["verify_rejected"]:
        fail(f"phase 11b: the shared round {shared}")
    # The fill hashes each provably whole shared xorb on the card: its
    # BG4 chunks in one kernel #3 launch, the rest in one kernel #1 launch.
    want = {"blake3_chunks": [0, 0], "bg4_regroup": [0, 0],
            "bg4_fused_verify": [0, 0]}
    for a in routed.shared.assignments:
        bg4, rest = bg4_chunks_of(
            cfg_a.xorb_cache_path(a.hash_hex).read_bytes())
        if a.fetch_info.range.start != 0 or \
                a.fetch_info.range.end != bg4 + rest:
            continue  # a partial unit: its frames are checked, not hashed
        for name, n in (("bg4_fused_verify", bg4), ("blake3_chunks", rest)):
            if n:
                want[name][0] += 1
                want[name][1] += n
    if any(list(launches[k]) != want[k] for k in want):
        fail(f"phase 11b: kernel launches (rows) {launches}, the shared "
             f"plan predicts {want}")
    if not st["hbm"]["sharded"]:
        fail("phase 11b: the landing is not sharded")
    host = load_checkpoint(res.snapshot_dir, "cpu")
    if params_digest(res.params) != params_digest(host):
        fail("phase 11b: the sharded tree's digest != the file's")

    # The raw landing decodes in place: each expert's FFN stays
    # params_from_hf of the raw landing: the one sharded tree (each
    # expert gathered once onto the slot that holds it whole), and the
    # expert-parallel decode tree built from it.
    mcfg = moe.MoEConfig.from_hf(MIXTRAL_CONFIG)
    fam_want, mmargin, mtol = pool_out["mixtral_family"]
    prompt = pool_out["mixtral_prompt"]
    t0 = time.monotonic()
    raw_tree = moe.params_from_hf(res.params, mcfg, dtype=torch.bfloat16)
    res.params = None
    params = tp.decode_params(raw_tree, mcfg)
    torch.cuda.synchronize(dev)
    raw_build_s = time.monotonic() - t0
    raw_gather = params.gather_bytes
    head_bytes = raw_tree["lm_head"].nbytes
    del raw_tree
    if params.experts != [range(2 * s, 2 * s + 2) for s in range(4)] \
            or raw_gather != head_bytes:
        fail(f"phase 11b: the raw landing's tree holds experts "
             f"{params.experts}, its decode tree gathered {raw_gather:,} B "
             f"(the head {head_bytes:,} B)")
    moe.generate_cached(params, mcfg, [prompt], 2)  # warm-up
    torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    raw = np.atleast_2d(moe.generate_cached(params, mcfg, [prompt],
                                            steps).cpu().numpy())
    raw_rate = steps / (time.monotonic() - t0)
    raw_note, raw_compared = tokens_near(
        "phase 11b mixtral raw-landing greedy batch 1", raw, fam_want,
        mmargin, mtol)
    del params
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    tree = land_moe_expert_sharded(bridge.cache, [(rec, header)], mcfg,
                                   mesh, placement, dtype=torch.bfloat16)
    land_s = time.monotonic() - t0
    bridge.close()
    for leaf in ("w1", "w3", "w2"):
        stacked = tree["blocks"]["moe"][leaf]
        for slot in range(4):
            shard = stacked.shard(slot)
            experts = placement.experts_of_host(slot)
            if experts != [2 * slot, 2 * slot + 1] or shard.shape[1] != 2:
                fail(f"phase 11b: slot {slot} holds {shard.shape}, "
                     f"placement {experts}")
            for j, e in enumerate(experts):
                name = (f"model.layers.0.block_sparse_moe.experts.{e}."
                        f"{leaf}.weight")
                if not torch.equal(int_view(shard[0, j].cpu()),
                                   int_view(host[name].T)):
                    fail(f"phase 11b: slot {slot}'s expert {e} {leaf} "
                         "differs from the file's")
    del host
    params = tp.moe_params(tree, mcfg)
    moe.generate_cached(params, mcfg, [prompt], 2)  # warm-up
    torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    got = np.atleast_2d(moe.generate_cached(params, mcfg, [prompt],
                                            steps).cpu().numpy())
    rate = steps / (time.monotonic() - t0)
    mnote, mcompared = tokens_near("phase 11b mixtral greedy batch 1", got,
                                   fam_want, mmargin, mtol)
    del params, tree
    torch.cuda.empty_cache()
    shutil.rmtree(work / "m")
    shutil.rmtree(work / "x")
    print(f"phase 11b mesh mixtral ({card}): {MIXTRAL_REPO} (1 layer) over "
          f"{{'expert': 4}} on [{dev}] * 4: pull {pull_s:.2f} s, "
          f"{landing_summary(st)}; pod: expert_routed, {pod['n_experts']} "
          f"experts, {pod['expert_units_fetched']} expert units "
          f"({pod['expert_bytes']:,} B) fetched by their slots = the routed "
          f"plan's, 0 failed, ici_bytes_saved {pod['ici_bytes_saved']:,}; "
          f"shared round {shared['filled']}/{shared['units']} units, "
          f"kernel launches (rows) {launches} = the shared plan's; "
          f"digest = the file's; the sharded tree of the raw landing "
          f"(whole experts a slot) and its expert-parallel decode tree "
          f"built in {raw_build_s:.2f} s, the decode tree gathered "
          f"{raw_gather:,} B (the head), bf16 greedy {raw_rate:.2f} tok/s, "
          f"tokens vs "
          f"phase 9's {raw_note} "
          f"({raw_compared} positions); "
          f"land_moe_expert_sharded {land_s:.2f} s, "
          f"slot s holds experts 2s, 2s+1 byte-equal to the file's; "
          f"expert-parallel bf16 greedy {rate:.2f} tok/s, tokens vs phase "
          f"9's float32 family path {mnote} ({mcompared} positions, "
          f"tolerance {mtol:.4f}); phase wall "
          f"{time.monotonic() - wall0:.2f} s")
    return {name: n for name, (n, _rows) in launches.items()}


# ── Phase 12: the training plane ──

# Phase 12's recipe: examples/finetune_and_export.py's AdamW (lr 1e-4,
# 1000 total steps) with one warmup step, on one fixed seeded (2, 129)
# batch.
FT_BATCH = (2, 129)
# 12b and 13b train Llama-3.2-1B's width at this depth, its first layers
# (depth cut 16 → 2: the float32 export, push and delta pull of all 16
# took ~135 s of the command's 1200 s once phase 19 came).
FT_LAYERS = 2
FT_CONFIG = dict(LLAMA_CONFIG, num_hidden_layers=FT_LAYERS)
FT_ADAMW = {"lr": 1e-4, "warmup_steps": 1, "total_steps": 1000}
FT_STEPS = 5
# 12c: Llama-3.2-1B's width with its depth cut to 2 layers.
CP_LAYERS = 2
CP_MESH = {"data": 2, "seq": 4}
PIPE_MESH, PIPE_MICROBATCHES, PIPE_BATCH = {"pipe": 2}, 4, 4
# 12c's tolerances, stated before the first card run. The context-
# parallel loss within 1e-5 of train_step's (the VERIFY skill's bar); its
# SGD-updated params (lr 1e-3) within 1e-6 of train_step's, a gradient
# difference of 1e-3 (the two sum the same products in other orders;
# measured on the CPU at a tiny width: 4e-9). The pipeline's output and
# every gradient within 1e-5 of the largest magnitude of the plain layer
# loop's (a microbatch of one row may take another cuBLAS algorithm).
CP_LOSS_TOL, CP_PARAM_TOL, PIPE_TOL = 1e-5, 1e-6, 1e-5


def step_ms(dev, fn) -> tuple[float, object]:
    """``fn()``'s wall on ``dev`` in ms (CUDA events on a card) and its
    result."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end), out


def ft_batch(vocab: int, seed: int, dev, shape=FT_BATCH):
    import torch

    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, vocab, shape)).to(dev)


def gpt2_finetune_phase(ckpt: Path, work: Path, seed: int, dev) -> dict:
    """Phase 12a: GPT-2 at its published width from phase 3's checkpoint:
    three AdamW steps, ``save_train_state``, ``restore_train_state`` onto
    ``dev``, two more steps; the parameters and moments bit-equal to an
    uninterrupted five-step run, the first loss within 1e-4 of the port's
    CPU float32 ``loss_fn`` on the same tree. Returns phase 18's
    reference: the batch seed, the first two losses and the parameters and
    first moments after step 2, on the host."""
    import functools

    import torch

    from zest_tpu_torch.models import gpt2, training
    from zest_tpu_torch.models.checkpoint import (restore_train_state,
                                                  save_train_state)
    from zest_tpu_torch.models.loader import load_checkpoint

    wall0 = time.monotonic()
    cfg = gpt2.GPT2Config.from_hf(GPT2_CONFIG)
    params_cpu = gpt2.params_from_hf(load_checkpoint(ckpt, "cpu"), cfg)
    n_params = sum(t.numel() for t in training.tree_leaves(params_cpu))
    batch = ft_batch(cfg.vocab_size, seed + 12, dev)
    with torch.no_grad():
        cpu_loss = float(gpt2.loss_fn(params_cpu, batch.cpu(), cfg))
    tx = training.adamw(**FT_ADAMW)
    step = training.make_train_step(tx, functools.partial(gpt2.loss_fn,
                                                          cfg=cfg))

    def fresh():
        return training.create_state(training.tree_map(
            lambda t: t.to(dev, copy=True), params_cpu), tx)

    state, losses, times = fresh(), [], []
    for k in range(FT_STEPS):
        ms, (state, loss) = step_ms(dev, lambda s=state: step(s, batch))
        times.append(ms)
        losses.append(float(loss))
        if k == 1:  # phase 18's reference: the state after step 2
            after2 = {name: training.tree_map(
                lambda t: t.detach().to("cpu", copy=True), tree)
                for name, tree in (("params", state.params),
                                   ("mu", state.opt_state.mu))}
    first = losses[0]
    if not abs(first - cpu_loss) <= 1e-4:
        fail(f"phase 12a: first loss {first} off the CPU's {cpu_loss} by "
             f"more than 1e-4")
    if not all(np.isfinite(losses)):
        fail(f"phase 12a: losses {losses}")
    part = fresh()
    for _ in range(3):
        part, _ = step(part, batch)
    path = work / "gpt2-train-state" / "step_000003"
    t0 = time.monotonic()
    save_train_state(path, part)
    save_s = time.monotonic() - t0
    state_bytes = (path / "arrays.safetensors").stat().st_size
    like = fresh()
    del part
    t0 = time.monotonic()
    part = restore_train_state(path, like)
    restore_s = time.monotonic() - t0
    del like
    if part.step != 3 or part.params["wte"].device != dev:
        fail(f"phase 12a: restored step {part.step} on "
             f"{part.params['wte'].device}")
    for _ in range(2):
        part, _ = step(part, batch)
    for name, tree in (("params", lambda s: s.params),
                       ("mu", lambda s: s.opt_state.mu),
                       ("nu", lambda s: s.opt_state.nu)):
        for (p, a), (_, b) in zip(training.tree_paths(tree(part)),
                                  training.tree_paths(tree(state))):
            if not torch.equal(a, b):
                fail(f"phase 12a: resumed {name} {'/'.join(p)} differs from "
                     "the uninterrupted run's")
    if part.step != state.step or part.opt_state.count != FT_STEPS:
        fail(f"phase 12a: steps {part.step}/{state.step}")
    shutil.rmtree(work / "gpt2-train-state")
    del state, part
    torch.cuda.empty_cache()
    print(f"phase 12a gpt2 finetune ({card_label()}): {n_params:,} params, "
          f"AdamW {FT_ADAMW}, batch {FT_BATCH}: losses "
          f"{[round(x, 6) for x in losses]}; first {first:.6f} vs CPU "
          f"float32 {cpu_loss:.6f} (|d| {abs(first - cpu_loss):.2e} <= "
          f"1e-4); step ms {[round(t, 2) for t in times]}; save_train_state "
          f"{save_s:.2f} s ({state_bytes:,} B), restore {restore_s:.2f} s; "
          f"3 + restore + 2 steps bit-equal to 5 (params, mu, nu); phase "
          f"wall {time.monotonic() - wall0:.2f} s")
    return {"batch_seed": seed + 12, "losses": losses[:2], **after2}


def llama_finetune_phase(work: Path, url: str, cfg_a, llama_ref: dict,
                         seed: int, steps: int, dev) -> dict:
    """Phase 12b: Llama-3.2-1B at its published width, its first
    ``FT_LAYERS`` layers, from phase 7's push (node ``l``'s snapshot): the
    float32 tree on ``dev``,
    five AdamW steps, ``export_hf_safetensors``, ``push_checkpoint`` as a
    new revision of phase 7's repo (the kernel re-verifies every minted
    chunk), a delta pull on node ``l`` over revision A's landed tree, and
    greedy decode from the swapped tree. Returns the push's kernel
    launches and what phase 13b holds its sharded steps to: the losses,
    the step times, layer 0's ``q_w`` and ``down_w`` after the second
    step (the first that moves a parameter: one warmup step makes the
    first learning rate 0) on the host, and the step's memory beyond the
    parameters, gradients and moments."""
    import functools

    import torch

    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models import llama, training
    from zest_tpu_torch.models.checkpoint import export_hf_safetensors
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.ops import blake3_cuda
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    wall0 = time.monotonic()
    cfg = llama.LlamaConfig.from_hf(FT_CONFIG)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        mem0 = torch.cuda.memory_allocated(dev)
    # Revision A's tree on the card: the delta pull's base. The trainer's
    # float32 tree is its own allocation (params_from_hf casts bf16).
    base = load_checkpoint(llama_ref["snapshot"], dev)
    params = llama.params_from_hf(base, cfg, torch.float32)
    n_params = sum(t.numel() for t in training.tree_leaves(params))
    batch = ft_batch(cfg.vocab_size, seed + 13, dev)
    t0 = time.monotonic()
    with torch.no_grad():
        cpu_loss = float(llama.loss_fn(llama.params_from_hf(
            load_checkpoint(llama_ref["snapshot"], "cpu"), cfg), batch.cpu(),
            cfg))
    cpu_s = time.monotonic() - t0
    tx = training.adamw(**FT_ADAMW)
    step = training.make_train_step(tx, functools.partial(llama.loss_fn,
                                                          cfg=cfg))
    state = training.create_state(params, tx)
    del params
    losses, times, after2 = [], [], {}
    for k in range(FT_STEPS):
        ms, (state, loss) = step_ms(dev, lambda s=state: step(s, batch))
        times.append(ms)
        losses.append(float(loss))
        if k == 1:
            blocks = state.params["blocks"]
            mu = state.opt_state.mu["blocks"]
            after2 = {name: t[0].to("cpu", copy=True) for name, t in (
                ("q_w", blocks["attn"]["q_w"]),
                ("down_w", blocks["mlp"]["down_w"]),
                ("mu q_w", mu["attn"]["q_w"]),
                ("mu down_w", mu["mlp"]["down_w"]))}
    peak = (torch.cuda.max_memory_allocated(dev) - mem0
            if dev.type == "cuda" else 0)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in training.tree_leaves(state.params))
    base_bytes = sum(t.numel() * t.element_size() for t in base.values())
    # Beyond the base tree, the float32 parameters, their gradients and
    # both moments: the activations and the update's temporaries.
    overhead = peak - base_bytes - 4 * param_bytes
    # Where a step's time goes: the forward and backward alone (the
    # state unchanged); the rest of a step is the clip and the update.
    grad_ms, _ = step_ms(dev, lambda: training.value_and_grad(
        llama.loss_fn, state.params, batch, cfg))
    if not all(np.isfinite(losses)):
        fail(f"phase 12b: losses {losses}")
    if not abs(losses[0] - cpu_loss) <= LOGITS_TOL:
        fail(f"phase 12b: first loss {losses[0]} off the CPU float32 "
             f"loss {cpu_loss} by more than {LOGITS_TOL:.0e}")
    if not losses[-1] < losses[0]:
        fail(f"phase 12b: the loss did not fall: {losses}")
    step_s = sum(times[1:]) / (len(times) - 1) / 1e3
    tokens = FT_BATCH[0] * (FT_BATCH[1] - 1)

    # ── export, push as a new revision of phase 7's repo ──
    trained = state.params
    state = None  # the moments go; the trained tree stays for the tokens
    ck = work / "llama-finetuned"
    ck.mkdir()
    (ck / "config.json").write_text(json.dumps(
        dict(FT_CONFIG, torch_dtype="float32"), indent=2))
    t0 = time.monotonic()
    export_hf_safetensors(ck / "model.safetensors", trained, cfg)
    export_s = time.monotonic() - t0
    export_bytes = (ck / "model.safetensors").stat().st_size
    exported = load_checkpoint(ck, "cpu")
    want_digest, n_export = params_digest(exported), len(exported)
    del exported
    blake3_cuda.COUNTER.reset()  # counts from here are the push's
    t0 = time.monotonic()
    pushed = push_checkpoint(cfg_a, LLAMA_REPO, ck,
                             base_revision=llama_ref["revision"],
                             device=dev, notify=False)
    push_s = time.monotonic() - t0
    launches, rows = blake3_cuda.COUNTER.launches, blake3_cuda.COUNTER.rows
    if launches < 1 or rows != pushed.minted_chunks:
        fail(f"phase 12b: the push's kernel hashed {rows} chunks in "
             f"{launches} launches; it minted {pushed.minted_chunks}")

    # ── the delta pull on node l over revision A's tree ──
    cfg_l = Config(hf_home=work / "l" / "hf", cache_dir=work / "l" / "zest",
                   endpoint=url)
    t0 = time.monotonic()
    res = pull_model(cfg_l, LLAMA_REPO, revision=pushed.revision,
                     device=dev, base_params=base,
                     base_revision=llama_ref["revision"])
    pull_s = time.monotonic() - t0
    st = res.stats
    d, swap = st.get("delta"), st["hbm"].get("swap", {})
    if not d or d.get("base_revision") != llama_ref["revision"]:
        fail(f"phase 12b: no delta over revision A: {d}")
    if len(res.params) != n_export:
        fail(f"phase 12b: {len(res.params)} tensors swapped in, the export "
             f"has {n_export}")
    got_digest = params_digest(res.params)
    if got_digest != want_digest:
        fail("phase 12b: the swapped tree's digest is not the export's")
    swapped = llama.params_from_hf(res.params, cfg, torch.float32)
    res.params = None
    prompts = llama_ref["prompts"]
    notes = []
    for b in (1, 4):
        mine = llama.generate_cached(trained, cfg, prompts[:b], steps)
        theirs = llama.generate_cached(swapped, cfg, prompts[:b], steps)
        if not torch.equal(mine, theirs):
            fail(f"phase 12b: batch {b}: tokens from the swapped tree "
                 "differ from the trainer's")
        notes.append(f"b{b} {mine.shape[-1] - 8} tokens equal")
    del trained, swapped, base
    shutil.rmtree(ck)
    shutil.rmtree(work / "l")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    d_print = {k: v for k, v in d.items() if k != "files"}
    print(f"phase 12b llama finetune ({card_label()}): {LLAMA_REPO} at its "
          f"published width, its first {FT_LAYERS} layers, float32 "
          f"({n_params:,} params), AdamW "
          f"{FT_ADAMW}, batch {FT_BATCH}: losses "
          f"{[round(x, 6) for x in losses]}; first vs CPU float32 "
          f"{cpu_loss:.6f} (|d| {abs(losses[0] - cpu_loss):.2e} <= "
          f"{LOGITS_TOL:.0e}; CPU forward {cpu_s:.2f} s); step ms "
          f"{[round(t, 2) for t in times]}: train_step_s {step_s:.4f} "
          f"(steps 2-5), {tokens / step_s:.1f} tokens/s; forward+backward "
          f"alone {grad_ms:.2f} ms (the clip and update the rest); peak "
          f"allocation rise {peak:,} B ({overhead:,} B beyond A's bf16 "
          f"tree and 4 x the float32 parameters)")
    print(f"  export {export_s:.2f} s ({export_bytes:,} B); push_s "
          f"{push_s:.2f} ({pushed.new_xorbs} xorbs, {pushed.minted_chunks} "
          f"chunks, kernel launches {launches}); delta pull on node l "
          f"{pull_s:.2f} s, time_to_swap_s {st.get('time_to_swap_s')}, "
          f"delta {d_print}, swap {swap}; digest = the export's; greedy "
          f"from the swapped tree = the trainer's ({', '.join(notes)}); "
          f"phase wall {time.monotonic() - wall0:.2f} s")
    return {"launches": launches, "losses": losses, "step_s": step_s,
            "times": times, "after2": after2, "overhead": overhead,
            "batch_seed": seed + 13}


def parallel_train_phase(seed: int, dev) -> None:
    """Phase 12c: context and pipeline parallelism at Llama-3.2-1B's
    width, 2 layers, on slots of ``dev``: ``cp_train_step`` over
    ``{"data": 2, "seq": 4}`` against ``train_step``, and
    ``pipeline_blocks`` over ``{"pipe": 2}`` (4 microbatches of a batch of
    4) against the plain layer loop, output and gradients."""
    import torch

    from zest_tpu_torch.models import llama, training
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.parallel.pipeline import pipeline_blocks

    wall0 = time.monotonic()
    cfg = llama.LlamaConfig.from_hf(dict(LLAMA_CONFIG,
                                         num_hidden_layers=CP_LAYERS))
    params = llama.init_params(torch.Generator().manual_seed(seed + 14),
                               cfg, device=dev)
    n_params = sum(t.numel() for t in training.tree_leaves(params))
    batch = ft_batch(cfg.vocab_size, seed + 14, dev)
    mesh = model_mesh(CP_MESH, [dev] * 8)
    llama.train_step(params, batch, cfg)  # warm-ups: timed calls only
    llama.cp_train_step(params, batch, cfg, mesh)
    ms, (want, loss) = step_ms(dev, lambda: llama.train_step(params, batch,
                                                             cfg))
    cp_ms, (got, cp_loss) = step_ms(dev, lambda: llama.cp_train_step(
        params, batch, cfg, mesh))
    loss_d = abs(float(cp_loss) - float(loss))
    param_d = max(float((a - b).abs().max()) for a, b in zip(
        training.tree_leaves(got), training.tree_leaves(want)))
    if not loss_d <= CP_LOSS_TOL or not param_d <= CP_PARAM_TOL:
        fail(f"phase 12c: cp_train_step loss off by {loss_d:.2e}, params "
             f"by {param_d:.2e}")
    del got, want

    pmesh = model_mesh(PIPE_MESH, [dev] * 2)
    ids = ft_batch(cfg.vocab_size, seed + 15, dev,
                   (PIPE_BATCH, FT_BATCH[1] - 1))

    def block(x, lp):
        return llama._block(x, lp, cfg,
                            lambda h, p: llama._attention(h, p, cfg)), None

    def run(fn):
        blocks = training.tree_map(
            lambda t: t.detach().requires_grad_(), params["blocks"])
        x = params["wte"][ids].detach().requires_grad_()
        with torch.enable_grad():
            out = fn(blocks, x)
            (out.float() ** 2).sum().backward()
        return out.detach(), [t.grad for t in training.tree_leaves(
            blocks)] + [x.grad]

    def loop(blocks, x):
        for i in range(cfg.n_layer):
            x, _ = block(x, training.tree_map(lambda t: t[i], blocks))
        return x

    def pipe(b, x):
        return pipeline_blocks(block, b, x, pmesh, PIPE_MICROBATCHES)

    run(loop), run(pipe)  # warm-ups
    loop_ms, (want_out, want_g) = step_ms(dev, lambda: run(loop))
    pipe_ms, (got_out, got_g) = step_ms(dev, lambda: run(pipe))
    errs = [float((a - b).abs().max() / b.abs().max())
            for a, b in zip([got_out] + got_g, [want_out] + want_g)]
    if not max(errs) <= PIPE_TOL:
        fail(f"phase 12c: pipeline_blocks off the layer loop by "
             f"{max(errs):.2e} (relative)")
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    print(f"phase 12c parallel ({card_label()}): Llama-3.2-1B width, "
          f"{CP_LAYERS} layers ({n_params:,} params), batch {FT_BATCH}: "
          f"cp_train_step over {CP_MESH} on [{dev}] * 8 loss "
          f"{float(cp_loss):.6f}, |d| vs train_step {loss_d:.2e} (<= "
          f"{CP_LOSS_TOL:.0e}), params max |d| {param_d:.2e} (<= "
          f"{CP_PARAM_TOL:.0e}); step {cp_ms:.1f} ms vs train_step "
          f"{ms:.1f} ms; pipeline_blocks over {PIPE_MESH}, "
          f"{PIPE_MICROBATCHES} microbatches of batch {PIPE_BATCH}: output "
          f"and {len(errs) - 1} gradients within {max(errs):.2e} of the "
          f"layer loop (relative, <= {PIPE_TOL:.0e}); forward+backward "
          f"{pipe_ms:.1f} ms vs loop {loop_ms:.1f} ms; phase wall "
          f"{time.monotonic() - wall0:.2f} s")


# ── Phase 13: the sharded tree's life cycle ──

SWAP_MESH = {"model": 4}
# Phase 14: each pod of the federated pull lands over two slots of the
# card; the lossy round's four coop hosts are two pods of two, each pod
# one slice.
FED_MESH = {"model": 2}
FED_SLOTS = 2
LOSSY_PODS = (0, 0, 1, 1)
TRAIN_MESH = {"data": 2, "model": 2}
TP_CP_MESH = {"seq": 2, "model": 2}
EP_MESH = {"expert": 4}
SHARD_STEPS = 3
# 13b against 12b: the step-1 loss within 1e-4 relative (the same start
# and batch; the sharded sums run in other orders). Layer 0's q_w and
# down_w after step 2, the first that moves a parameter: their first
# moments (0.09 g1 + 0.1 g2, linear in the gradients) within 1e-5 of the
# leaf's largest; the parameters within 2 lr of 12b's, and at most 1e-3
# of their elements beyond 1e-6. Adam's update at step 2 is lr times
# mu_hat / (sqrt(nu_hat) + eps), at most ~1 in size, and an element whose
# gradient sits near eps = 1e-8 turns a last-ulp gradient difference into
# an O(lr) one (the first card run: 1.561e-05 on q_w, past the reference's
# SGD tolerance of 1e-5 abs / 1e-4 rel that was first stated here).
SHARD_LOSS_RTOL, SHARD_MU_TOL = 1e-4, 1e-5
SHARD_PARAM_BOUND, SHARD_PARAM_SHARE = 2 * FT_ADAMW["lr"], 1e-3
# 13c: cp_train_step with a model axis against train_step (the reference's
# tolerances): the loss 1e-5, down_w after one SGD step 1e-5 abs / 1e-4 rel.
TP_CP_TOL, TP_CP_ATOL, TP_CP_RTOL = 1e-5, 1e-5, 1e-4
# 13d: Mixtral at its published width, 1 layer, float32, on a (2, 65)
# batch (128 tokens routed as one group).
EP_BATCH = (2, 65)
GIB = 1 << 30


def _replicas_equal(tree) -> bool:
    """Every replica of every block of a sharded tree bit-equal."""
    from zest_tpu_torch.models.training import tree_leaves

    import torch

    return all(torch.equal(t.shards[g[0]], t.shards[s])
               for t in tree_leaves(tree) for g in t.replica_groups()
               for s in g[1:])


def _storages(sharded) -> dict[int, int]:
    """The bytes of each storage the shards of ``sharded`` (an iterable
    of sharded tensors) sit in, by the storage's address: shards that
    share a buffer count it once."""
    out = {}
    for t in sharded:
        for x in t.shards.values():
            st = x.untyped_storage()
            out[st.data_ptr()] = st.nbytes()
    return out


def _slot_bytes(tree) -> int:
    """Bytes a sharded tree holds on its slots (replicas counted)."""
    from zest_tpu_torch.models.training import tree_leaves

    return sum(x.numel() * x.element_size() for t in tree_leaves(tree)
               for x in t.shards.values())


def mesh_swap_phase(work: Path, url: str, sha_a: str, swap_ref: dict,
                    dev) -> dict:
    """Phase 13a: the hot-swap of a sharded tree. A fresh node pulls
    phase 3's GPT-2 revision A over ``SWAP_MESH`` on four slots of ``dev``
    with the pod pre-pass, then ``pull_model(..., mesh=, base_params=,
    base_revision=)`` to phase 5b's revision B: reused shards > 0 and the
    plan's count, the digest a cold mesh pull's and 5b's, every slot's
    shard the file's slice, the base consumed, the landing's peak
    allocation rise within 5b's rule, the round's kernel #3/#1 launches
    and rows those of the units it filled, and GPT-2's greedy tokens from
    the swapped tree 5b's. Returns the kernels' launches in the swap."""
    import torch

    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.loader import (_STREAM_COMMIT_BYTES,
                                              load_checkpoint, params_digest)
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.parallel import DistributionPlan
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.transfer import pull as pull_mod

    wall0 = time.monotonic()
    sha_b = swap_ref["revision"]
    mesh = model_mesh(SWAP_MESH, [dev] * 4)
    n = mesh.size

    def node(name):
        return Config(hf_home=work / name / "hf",
                      cache_dir=work / name / "zest", endpoint=url,
                      hbm_staging_bytes=POD_BUDGET)

    cfg_s = node("s13")
    t0 = time.monotonic()
    res_a = pull_mod.pull_model(cfg_s, REPO, revision=sha_a, device=dev,
                                mesh=mesh, pod=True)
    pull_a_s = time.monotonic() - t0
    base = res_a.params
    res_a.params = None
    if not res_a.stats["hbm"]["sharded"] or len(base) != 148:
        fail(f"phase 13a: revision A landed {len(base)} tensors, sharded "
             f"{res_a.stats['hbm']['sharded']}")
    refs = {name: weakref.ref(t) for name, t in base.items()}
    counters = (blake3_cuda.COUNTER, bg4_cuda.COUNTER,
                bg4_cuda.FUSED_COUNTER)
    mem: dict = {}
    stage = pull_mod.stage_cached_to_hbm

    def landing(*a, **k):
        # The swap's own landing, after the pod round freed its pool.
        torch.cuda.synchronize(dev)
        mem["before"] = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = stage(*a, **k)
        torch.cuda.synchronize(dev)
        mem["peak"] = torch.cuda.max_memory_allocated(dev)
        return out

    for c in counters:
        c.reset()  # counts from here are the swap's
    pull_mod.stage_cached_to_hbm = landing
    try:
        res = pull_mod.pull_model(cfg_s, REPO, revision=sha_b, device=dev,
                                  mesh=mesh, pod=True, base_params=base,
                                  base_revision=sha_a)
    finally:
        pull_mod.stage_cached_to_hbm = stage
    launches = {name: (c.launches, c.rows) for name, c in zip(
        ("blake3_chunks", "bg4_regroup", "bg4_fused_verify"), counters)}
    st = res.stats
    swap, d, pod = st["hbm"].get("swap"), st.get("delta"), st.get("pod")
    if not swap or not d or not pod or pod.get("skipped"):
        fail(f"phase 13a: swap {swap}, delta {d and d.get('tensors')}, "
             f"pod {pod}")
    params = res.params
    reused = {name for name, t in params.items()
              if name in refs and refs[name]() is t}
    if not 0 < len(reused) == swap["reused_tensors"] \
            == d["tensors"]["reused"]:
        fail(f"phase 13a: {len(reused)} shards reused in place, swap "
             f"{swap}, plan {d['tensors']}")
    if base:
        fail(f"phase 13a: {len(base)} tensors left in the base dict")
    landed = [t for name, t in params.items() if name not in reused]
    landed_alloc = sum(x.numel() * x.element_size() for t in landed
                       for x in t.shards.values())
    group = max([_STREAM_COMMIT_BYTES] + [int(t.nbytes) for t in landed])
    rise = mem["peak"] - mem["before"]
    if rise > landed_alloc + group:
        fail(f"phase 13a: the landing's peak allocation rose {rise:,} B, "
             f"above the landed shards {landed_alloc:,} B + one commit "
             f"group {group:,} B")
    # The round verifies on the card each unit its layout takes for a
    # whole xorb (the one planned range of its hash starts at chunk 0):
    # the unit's BG4 chunks in one kernel #3 launch, the rest in one
    # kernel #1 launch. A unit that is only a prefix of its xorb (B reads
    # A's last xorb up to the chunks it replaced) hashes to another xorb
    # hash and is rejected, as the JAX package's rule rejects it; the
    # landing then reads that xorb from the cache A's pull filled.
    plan = DistributionPlan.build(gpt2_recs(cfg_s, sha_b), n)
    want, prefixes = plan_launches(plan, cfg_s)
    if pod["units"] != len(plan.assignments) \
            or pod["filled"] + pod["verify_rejected"] != pod["units"] \
            or pod["verify_rejected"] != prefixes \
            or any(list(launches[k]) != want[k] for k in want):
        fail(f"phase 13a: pod {pod}; kernel launches (rows) {launches}, "
             f"the plan's whole-xorb units predict {want} and {prefixes} "
             "rejected prefixes")
    digest = params_digest(params)
    cold = pull_mod.pull_model(node("c13"), REPO, revision=sha_b, device=dev,
                               mesh=mesh, pod=False)
    if not digest == params_digest(cold.params) == swap_ref["digest"]:
        fail("phase 13a: the swapped tree's digest != a cold mesh pull's "
             "or phase 5b's")
    cold.params = None
    host = load_checkpoint(res.snapshot_dir, "cpu")
    for name, t in params.items():
        for slot in range(n):
            got = t.shard(slot)
            if got.device != dev or not torch.equal(
                    got.cpu().view(torch.uint8),
                    host[name][t.index(slot)].contiguous().view(
                        torch.uint8)):
                fail(f"phase 13a: slot {slot}'s shard of {name} differs "
                     "from the file's slice")
    del host
    _, gen = load_generator(res.snapshot_dir, device=dev, tensors=params)
    prompts = swap_ref["prompts"]
    for batch in ([prompts[0]], prompts):
        out = gen(batch, swap_ref["steps"], stop_at_eos=False)
        if not np.array_equal(out, swap_ref["tokens"][len(batch)]):
            fail(f"phase 13a: batch {len(batch)}: tokens from the swapped "
                 "tree differ from phase 5b's")
    specs = sorted({str(tuple(t.spec)) for t in params.values()})
    del gen, params, refs
    res.params = None
    shutil.rmtree(work / "s13")
    shutil.rmtree(work / "c13")
    torch.cuda.empty_cache()
    print(f"phase 13a sharded hot-swap ({card_label()}): GPT-2 (148 "
          f"tensors) over {SWAP_MESH} on [{dev}] * {n}: revision A pulled "
          f"in {pull_a_s:.2f} s; the swap to B: time_to_swap_s "
          f"{st['time_to_swap_s']} (phase 5b, one device: "
          f"{swap_ref['time_to_swap_s']}); reused {len(reused)} sharded "
          f"tensors in place (= the plan's), landed "
          f"{swap['landed_tensors']} ({landed_alloc:,} B over the slots); "
          f"the landing's peak allocation +{rise:,} B (<= landed + one "
          f"group {group:,} B); pod round {pod} ({prefixes} prefix "
          f"unit(s) rejected, as predicted); kernel launches (rows) "
          f"{launches} = the plan's whole-xorb units'; specs {specs}; "
          f"digest = a cold "
          f"mesh pull's = phase 5b's; every shard the file's slice; "
          f"greedy at batch 1 and 4 = phase 5b's; phase wall "
          f"{time.monotonic() - wall0:.2f} s")
    return {name: k for name, (k, _rows) in launches.items()}


def sharded_train_phase(work: Path, url: str, llama_ref: dict,
                        ft_ref: dict, dev) -> None:
    """Phase 13b: AdamW on a sharded tree at Llama-3.2-1B's published
    width, 12b's depth. Phase 7's push is pulled at float32 over
    ``TRAIN_MESH`` on four slots of ``dev``, its first ``FT_LAYERS``
    layers turned into the training tree (``params_from_hf``: every leaf
    under
    ``param_specs``), and trained ``SHARD_STEPS`` steps with 12b's recipe
    on 12b's batch cut over ``data``: the step-1 loss 12b's, layer 0's
    q_w and down_w after step 2 12b's, the data replicas bit-equal after
    every step, the loss falling, the landing's and the training's peak
    allocation rises each within its written reckoning."""
    import functools

    import torch

    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models import llama, training
    from zest_tpu_torch.models.loader import _STREAM_COMMIT_BYTES
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.transfer.pull import pull_model

    wall0 = time.monotonic()
    cfg = llama.LlamaConfig.from_hf(FT_CONFIG)
    mesh = model_mesh(TRAIN_MESH, [dev] * 4)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    cfg_t = Config(hf_home=work / "t13" / "hf",
                   cache_dir=work / "t13" / "zest", endpoint=url,
                   land_dtype="f32")
    t0 = time.monotonic()
    res = pull_model(cfg_t, LLAMA_REPO, revision=llama_ref["revision"],
                     device=dev, mesh=mesh, pod=False)
    pull_s = time.monotonic() - t0
    t0 = time.monotonic()
    tree = llama.params_from_hf(res.params, cfg, torch.float32)
    torch.cuda.synchronize(dev)
    build_s = time.monotonic() - t0
    # The landing holds all 16 layers, so its peak has a reckoning of its
    # own (phase 11a's rule, with the tree built from it), written before
    # its first card run: the landed storages, the tree's new ones, and
    # two commit groups, the one being cut and the next (a group is
    # ``_STREAM_COMMIT_BYTES`` of bf16 file bytes cast to float32 on the
    # host, or one larger tensor alone).
    landed_st = _storages(res.params.values())
    tree_st = {k: v for k, v in _storages(training.tree_leaves(tree)).items()
               if k not in landed_st}
    group = max(2 * _STREAM_COMMIT_BYTES,
                max(t.nbytes for t in res.params.values()))
    land_peak = torch.cuda.max_memory_allocated(dev) - mem0
    land_reckoning = (sum(landed_st.values()) + sum(tree_st.values())
                      + 2 * group)
    if land_peak > land_reckoning:
        fail(f"phase 13b: the landing and tree build rose {land_peak:,} B, "
             f"above landed {sum(landed_st.values()):,} + tree "
             f"{sum(tree_st.values()):,} + two groups of {group:,} B")
    res.params = None
    shutil.rmtree(work / "t13")
    torch.cuda.empty_cache()
    # The training's reckoning, from the tree of 12b's depth on (mem0 is
    # still the level before the landing).
    torch.cuda.reset_peak_memory_stats(dev)
    held = _slot_bytes(tree)
    largest = max(x.numel() * x.element_size()
                  for t in training.tree_leaves(tree)
                  for x in t.shards.values())
    # The reckoning, written before the first card run: the parameters,
    # their gradients and both moments on the slots (4 x held), the
    # update's temporaries (3 x the largest shard), and 12b's activations
    # and temporaries beyond its 4 x parameters.
    reckoning = 4 * held + 3 * largest + max(ft_ref["overhead"], 0)
    batch = ft_batch(cfg.vocab_size, ft_ref["batch_seed"], dev)
    tx = training.adamw(**FT_ADAMW)
    step = training.make_train_step(tx, functools.partial(llama.loss_fn,
                                                          cfg=cfg))
    state = training.create_state(tree, tx)
    del tree
    specs_ok = all(m.spec == p.spec for m, p in zip(
        training.tree_leaves(state.opt_state.mu),
        training.tree_leaves(state.params)))
    losses, times, after2 = [], [], {}
    for k in range(SHARD_STEPS):
        ms, (state, loss) = step_ms(dev, lambda s=state: step(s, batch))
        times.append(ms)
        losses.append(float(loss))
        if not (_replicas_equal(state.params)
                and _replicas_equal(state.opt_state.mu)
                and _replicas_equal(state.opt_state.nu)):
            fail(f"phase 13b: the data replicas differ after step {k + 1}")
        if k == 1:
            blocks = state.params["blocks"]
            mu = state.opt_state.mu["blocks"]
            after2 = {name: t.full()[0].cpu() for name, t in (
                ("q_w", blocks["attn"]["q_w"]),
                ("down_w", blocks["mlp"]["down_w"]),
                ("mu q_w", mu["attn"]["q_w"]),
                ("mu down_w", mu["mlp"]["down_w"]))}
    peak = torch.cuda.max_memory_allocated(dev) - mem0
    held_state = 3 * held  # params and both moments, the grads gone
    del state
    torch.cuda.empty_cache()
    want = ft_ref["losses"][0]
    if not specs_ok:
        fail("phase 13b: a moment's spec is not its parameter's")
    if not abs(losses[0] - want) <= SHARD_LOSS_RTOL * abs(want):
        fail(f"phase 13b: step-1 loss {losses[0]} off 12b's {want} by more "
             f"than {SHARD_LOSS_RTOL:.0e} relative")
    errs, shares = {}, {}
    for name, got in after2.items():
        ref = ft_ref["after2"][name]
        d = (got - ref).abs()
        errs[name] = float(d.max())
        if name.startswith("mu "):
            bound = SHARD_MU_TOL * float(ref.abs().max())
            if not errs[name] <= bound:
                fail(f"phase 13b: layer 0's {name} after step 2 off 12b's "
                     f"by {errs[name]:.3e} > {bound:.3e}")
            continue
        shares[name] = float((d > 1e-6).float().mean())
        if not (errs[name] <= SHARD_PARAM_BOUND
                and shares[name] <= SHARD_PARAM_SHARE):
            fail(f"phase 13b: layer 0's {name} after step 2 off 12b's by "
                 f"{errs[name]:.3e} (bound {SHARD_PARAM_BOUND:.0e}), "
                 f"{shares[name]:.2e} of it beyond 1e-6")
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        fail(f"phase 13b: losses {losses}")
    if peak > reckoning:
        fail(f"phase 13b: the peak allocation rose {peak:,} B, above the "
             f"reckoning {reckoning:,} B")
    step_s = sum(times[1:]) / (len(times) - 1) / 1e3
    print(f"phase 13b sharded AdamW ({card_label()}): {LLAMA_REPO} at its "
          f"published width, its first {FT_LAYERS} layers, float32, over "
          f"{TRAIN_MESH} on "
          f"[{dev}] * 4: pulled in {pull_s:.2f} s, training tree built in "
          f"{build_s:.2f} s ({held:,} B on the slots; the state "
          f"{held_state:,} B); AdamW {FT_ADAMW} on 12b's batch {FT_BATCH} "
          f"cut over data: losses {[round(x, 6) for x in losses]} (12b "
          f"{[round(x, 6) for x in ft_ref['losses'][:SHARD_STEPS]]}; step 1 "
          f"|d| {abs(losses[0] - want):.2e}); layer 0 after step 2 vs 12b: "
          f"max |d| {', '.join(f'{k} {v:.2e}' for k, v in errs.items())}; "
          f"share beyond 1e-6 q_w {shares['q_w']:.2e}, down_w "
          f"{shares['down_w']:.2e}; "
          f"replicas bit-equal after every step; moments in the params' "
          f"specs; step ms {[round(t, 2) for t in times]}: train_step_s "
          f"{step_s:.4f} (steps 2-{SHARD_STEPS}) vs 12b's unsharded "
          f"{ft_ref['step_s']:.4f}; peak allocation rise {peak:,} B "
          f"(reckoning {reckoning:,} B = 4 x {held:,} + 3 x {largest:,} + "
          f"12b's {ft_ref['overhead']:,}); the landing and tree build's "
          f"peak rise {land_peak:,} B (<= landed {sum(landed_st.values()):,}"
          f" + tree {sum(tree_st.values()):,} + 2 x {group:,} B); "
          f"phase wall "
          f"{time.monotonic() - wall0:.2f} s")


def tp_cp_phase(seed: int, dev) -> None:
    """Phase 13c: TP×CP at Llama-3.2-1B's width, depth cut to
    ``CP_LAYERS`` as in 12c: ``cp_train_step`` over ``TP_CP_MESH`` on four
    slots of ``dev`` on the ``ShardedTensor`` tree laid out by
    ``param_specs`` (local heads in the ring, the o/down sums on each
    model row's lead) against the dense ``train_step``."""
    import torch

    from zest_tpu_torch.models import llama, training
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.parallel.sharding import shard_tree

    wall0 = time.monotonic()
    cfg = llama.LlamaConfig.from_hf(dict(LLAMA_CONFIG,
                                         num_hidden_layers=CP_LAYERS))
    params = llama.init_params(torch.Generator().manual_seed(seed + 14),
                               cfg, device=dev)
    n_params = sum(t.numel() for t in training.tree_leaves(params))
    batch = ft_batch(cfg.vocab_size, seed + 14, dev)
    mesh = model_mesh(TP_CP_MESH, [dev] * 4)
    sharded = shard_tree(params, llama.param_specs(cfg), mesh)
    llama.cp_train_step(sharded, batch, cfg, mesh)  # warm-up
    ms, (want, loss) = step_ms(dev, lambda: llama.train_step(params, batch,
                                                             cfg))
    cp_ms, (got, cp_loss) = step_ms(dev, lambda: llama.cp_train_step(
        sharded, batch, cfg, mesh))
    loss_d = abs(float(cp_loss) - float(loss))
    if not _replicas_equal(got):
        fail("phase 13c: the seq replicas differ after the step")
    g = got["blocks"]["mlp"]["down_w"].full()
    w = want["blocks"]["mlp"]["down_w"]
    down_d = float((g - w).abs().max())
    if not loss_d <= TP_CP_TOL + TP_CP_TOL * abs(float(loss)) \
            or not torch.allclose(g, w, atol=TP_CP_ATOL, rtol=TP_CP_RTOL):
        fail(f"phase 13c: cp_train_step over {TP_CP_MESH} loss off by "
             f"{loss_d:.2e}, down_w by {down_d:.2e}")
    del params, sharded, got, want
    torch.cuda.empty_cache()
    print(f"phase 13c TP x CP ({card_label()}): Llama-3.2-1B width, "
          f"{CP_LAYERS} layers ({n_params:,} params), batch {FT_BATCH}: "
          f"cp_train_step on the ShardedTensor tree (param_specs) over "
          f"{TP_CP_MESH} on [{dev}] * 4 loss "
          f"{float(cp_loss):.6f}, |d| vs train_step {loss_d:.2e} (atol "
          f"and rtol {TP_CP_TOL:.0e}), down_w max |d| {down_d:.2e} (atol "
          f"{TP_CP_ATOL:.0e}, rtol {TP_CP_RTOL:.0e}); step {cp_ms:.1f} ms vs "
          f"train_step {ms:.1f} ms; phase wall "
          f"{time.monotonic() - wall0:.2f} s")


def expert_train_phase(seed: int, dev) -> None:
    """Phase 13d: expert-parallel AdamW at Mixtral-8x7B's published width,
    depth cut to 1 layer (phase 9's cut), float32, over ``EP_MESH`` on
    four slots of ``dev``: random weights from ``--seed + 16`` laid out by
    ``moe.param_specs`` (slot ``s`` holds experts ``2s, 2s + 1`` only);
    the step-1 loss against the port's CPU float32 ``moe.loss_fn`` within
    ``LOGITS_TOL``, the loss falling over ``SHARD_STEPS`` steps, each
    expert's gradient and update on its owning slot's shard, the peak
    allocation rise within its reckoning."""
    import functools

    import torch

    from zest_tpu_torch.models import moe, training
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.parallel.sharding import shard_tree

    wall0 = time.monotonic()
    cfg = moe.MoEConfig.from_hf(MIXTRAL_CONFIG)
    t0 = time.monotonic()
    params = moe.init_params(torch.Generator().manual_seed(seed + 16), cfg,
                             device="cpu")
    init_s = time.monotonic() - t0
    n_params = sum(t.numel() for t in training.tree_leaves(params))
    batch = ft_batch(cfg.vocab_size, seed + 16, torch.device("cpu"),
                     EP_BATCH)
    t0 = time.monotonic()
    with torch.no_grad():
        cpu_loss = float(moe.loss_fn(params, batch, cfg))
    cpu_s = time.monotonic() - t0
    mesh = model_mesh(EP_MESH, [dev] * 4)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    mem0 = torch.cuda.memory_allocated(dev)
    tree = shard_tree(params, moe.param_specs(cfg), mesh)
    w1_0 = {s: t.to("cpu", copy=True)
            for s, t in tree["blocks"]["moe"]["w1"].shards.items()}
    del params
    held = _slot_bytes(tree)
    experts = sum(_slot_bytes(tree["blocks"]["moe"][k])
                  for k in ("w1", "w2", "w3"))
    largest = max(x.numel() * x.element_size()
                  for t in training.tree_leaves(tree)
                  for x in t.shards.values())
    # Parameters, gradients and both moments (4 x held), the update's
    # temporaries (3 x the largest shard) and 1 GiB for the activations
    # and the backward's buffers (128 tokens), as written before the
    # first card run.
    reckoning = 4 * held + 3 * largest + GIB
    batch = batch.to(dev)
    _, grads = training.value_and_grad(moe.loss_fn, tree, batch, cfg)
    for leaf in ("w1", "w2", "w3"):
        g, p = grads["blocks"]["moe"][leaf], tree["blocks"]["moe"][leaf]
        if g.spec != p.spec or any(
                g.shards[s].shape != p.shards[s].shape
                or g.shards[s].shape[1] != cfg.n_experts // mesh.size
                or g.shards[s].device != dev for s in p.shards):
            fail(f"phase 13d: {leaf}'s gradient is not laid out as its "
                 "experts are")
    del grads, g, p
    tx = training.adamw(**FT_ADAMW)
    step = training.make_train_step(tx, functools.partial(moe.loss_fn,
                                                          cfg=cfg))
    state = training.create_state(tree, tx)
    del tree
    losses, times = [], []
    for _ in range(SHARD_STEPS):
        ms, (state, loss) = step_ms(dev, lambda s=state: step(s, batch))
        times.append(ms)
        losses.append(float(loss))
    peak = torch.cuda.max_memory_allocated(dev) - mem0
    moved = []
    for s, t in state.params["blocks"]["moe"]["w1"].shards.items():
        changed = (t.cpu() != w1_0[s]).transpose(0, 1)
        moved.append(int(changed.reshape(changed.shape[0], -1).any(
            dim=1).sum()))
    del state
    torch.cuda.empty_cache()
    if not abs(losses[0] - cpu_loss) <= LOGITS_TOL:
        fail(f"phase 13d: step-1 loss {losses[0]} off the CPU float32 loss "
             f"{cpu_loss} by more than {LOGITS_TOL:.0e}")
    if not losses[-1] < losses[0] or not all(np.isfinite(losses)):
        fail(f"phase 13d: losses {losses}")
    if not all(m == cfg.n_experts // mesh.size for m in moved):
        fail(f"phase 13d: experts updated on each slot {moved}")
    if peak > reckoning:
        fail(f"phase 13d: the peak allocation rose {peak:,} B, above the "
             f"reckoning {reckoning:,} B")
    print(f"phase 13d expert-parallel AdamW ({card_label()}): "
          f"{MIXTRAL_REPO} at its published width, 1 layer, float32 "
          f"({n_params:,} params; init on the host {init_s:.2f} s) over "
          f"{EP_MESH} on [{dev}] * 4: {held:,} B on the slots, experts "
          f"{experts:,} B (each slot its 2), batch {EP_BATCH}: losses "
          f"{[round(x, 6) for x in losses]}; step 1 vs CPU float32 "
          f"{cpu_loss:.6f} (|d| {abs(losses[0] - cpu_loss):.2e} <= "
          f"{LOGITS_TOL:.0e}; CPU loss {cpu_s:.2f} s); gradients in the "
          f"experts' layout, experts updated per slot {moved}; step ms "
          f"{[round(t, 2) for t in times]}; peak allocation rise {peak:,} B "
          f"(reckoning {reckoning:,} B = 4 x {held:,} + 3 x {largest:,} + "
          f"1 GiB); phase wall {time.monotonic() - wall0:.2f} s")


def plan_launches(plan, cache_cfg) -> tuple[dict, int]:
    """What a fill of ``plan``'s pool owes the receipt kernels, per kernel
    ``[launches, rows]``: for each unit the layout takes for a whole xorb
    (the one planned range of its hash starts at chunk 0), one kernel #3
    launch over its BG4 chunks and one kernel #1 launch over the rest (the
    chunk schemes read from ``cache_cfg``'s copy of the xorb). Also the
    count of those units that are only a prefix of their xorb: their hash
    is another xorb's, so the fill rejects them."""
    from zest_tpu_torch.cas.compression import Scheme
    from zest_tpu_torch.cas.xorb import XorbReader
    from zest_tpu_torch.parallel import PoolLayout

    layout = PoolLayout.from_plan(plan)
    want = {"blake3_chunks": [0, 0], "bg4_regroup": [0, 0],
            "bg4_fused_verify": [0, 0]}
    prefixes = 0
    for a in plan.assignments:
        if a.hash_hex not in layout.full_xorbs:
            continue
        lo, hi = a.fetch_info.range.start, a.fetch_info.range.end
        schemes = XorbReader(cache_cfg.xorb_cache_path(
            a.hash_hex).read_bytes()).chunk_schemes
        bg4 = int((schemes[lo:hi] == int(Scheme.BG4_LZ4)).sum())
        prefixes += hi < len(schemes)
        for name, k in (("bg4_fused_verify", bg4),
                        ("blake3_chunks", hi - lo - bg4)):
            if k:
                want[name][0] += 1
                want[name][1] += k
    return want, prefixes


def reset_counters() -> None:
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda

    for c in (blake3_cuda.COUNTER, bg4_cuda.COUNTER, bg4_cuda.FUSED_COUNTER):
        c.reset()


def read_counters() -> dict:
    """Each kernel's ``[launches, rows]`` since the last reset."""
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda

    return {name: [c.launches, c.rows] for name, c in (
        ("blake3_chunks", blake3_cuda.COUNTER),
        ("bg4_regroup", bg4_cuda.COUNTER),
        ("bg4_fused_verify", bg4_cuda.FUSED_COUNTER))}


def gpt2_recs(cfg, revision: str) -> list:
    """GPT-2's reconstructions at ``revision``, as a node over ``cfg``
    reads them."""
    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.transfer.bridge import XetBridge

    bridge = XetBridge(cfg)
    try:
        bridge.authenticate(REPO, revision)
        return [bridge.get_reconstruction(e.xet_hash)
                for e in HubClient(cfg).list_files(REPO, revision)
                if e.is_xet]
    finally:
        bridge.close()


def federated_phase(work: Path, url: str, cfg_a, ckpt: Path, pushed,
                    digest: str, gpt2_ref: dict, dev) -> dict:
    """Phase 14a: the federated pull of revision A by two pods, each
    ``FED_MESH`` over ``dev``. Pod 0 pulls first: its own units and, with
    no address for pod 1, pod 1's from the CDN. Then, with pod 0's cache
    behind a ``DcnServer`` and a ``BtServer`` (pod 1's swarm peer), pod 1
    pulls with ``pod_addrs={0: ...}``: pod 0's units over DCN, its own from
    pod 0's seeder. Returns each kernel's launches over both pulls."""
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.parallel import DistributionPlan
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.transfer.dcn import DcnServer
    from zest_tpu_torch.transfer.federated import pod_owned_units
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.server import BtServer
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    wall0 = time.monotonic()
    mesh = model_mesh(FED_MESH, [dev] * FED_SLOTS)
    quiet = lambda *a, **k: print("  [fed]", *a, file=sys.stderr)  # noqa: E731

    def node(name):
        return Config(hf_home=work / name / "hf",
                      cache_dir=work / name / "zest", endpoint=url,
                      dcn_port=0, listen_port=0)

    recs = gpt2_recs(node("f14"), pushed.revision)
    plan = DistributionPlan.build(recs, FED_SLOTS)
    want, prefixes = plan_launches(plan, cfg_a)
    mine0, _ = pod_owned_units(recs, 0, 2)
    launches = dict.fromkeys(want, 0)
    stats, cdn = [], []
    servers, swarm = [], None
    try:
        for i in range(2):
            addrs = None
            if i == 1:
                servers = [DcnServer(node("f0")), BtServer(node("f0"))]
                addrs = {0: ("127.0.0.1", servers[0].start())}
                swarm = SwarmDownloader(node("f1"))
                swarm.add_direct_peer("127.0.0.1", servers[1].start())
            reset_counters()
            res = pull_model(node(f"f{i}"), REPO, revision=pushed.revision,
                             device=dev, pods=2, pod_index=i,
                             pod_addrs=addrs, mesh=mesh, pod=True,
                             swarm=swarm, log=quiet)
            got = read_counters()
            label = f"phase 14a pod {i}"
            pod = res.stats.get("pod") or {}
            if pod.get("skipped") \
                    or pod.get("units") != len(plan.assignments) \
                    or pod["verify_rejected"] != prefixes \
                    or pod["filled"] + prefixes != pod["units"]:
                fail(f"{label}: pod pre-pass {pod}, {prefixes} prefix "
                     "units")
            if got != want:
                fail(f"{label}: kernel launches (rows) {got}; the plan's "
                     f"whole-xorb units predict {want}")
            check_files(label, res, ckpt)
            check_tree(label, res, digest, dev)
            for k, v in got.items():
                launches[k] += v[0]
            stats.append(res.stats)
            cdn.append(res.stats["fetch"]["bytes"]["cdn"])
            if i == 0:
                del res  # pod 1's tree decodes below
    finally:
        for srv in servers:
            srv.shutdown()
        if swarm is not None:
            swarm.close()
    fed0, fed1 = (s["federated"] for s in stats)
    if fed1["dcn_units"] != len(mine0) or fed1["fallback_units"] \
            or fed1["failed_units"] or not fed1["dcn_bytes"]:
        fail(f"phase 14a: pod 1's federated block {fed1}; pod 0 owns "
             f"{len(mine0)} units")
    # The split between the tiers: pod 0's units reach pod 1 whole over
    # DCN, pod 1's own units from pod 0's swarm seeder, none from the CDN
    # (the two pods run in turn, so without the peer tier pod 1's own
    # units would be a second CDN copy of them).
    mine0_bytes = sum(fi.url_range_end - fi.url_range_start
                      for _, fi in mine0)
    peer1 = stats[1]["fetch"]["bytes"]["peer"]
    if cdn[1] or fed1["dcn_bytes"] != mine0_bytes \
            or peer1 != fed1["own_bytes"] + fed1["dcn_bytes"]:
        fail(f"phase 14a: pod 1 took {cdn[1]:,} CDN bytes and {peer1:,} "
             f"peer bytes; its federated block {fed1}; pod 0's units hold "
             f"{mine0_bytes:,} bytes")
    copy = pushed.new_xorb_bytes
    if sum(cdn) > 1.05 * copy:
        fail(f"phase 14a: CDN bytes {cdn} over both pods > 1.05 x {copy:,}")
    _, gen = load_generator(res.snapshot_dir, device=dev, tensors=res.params)
    for batch, tokens in gpt2_ref["tokens"]:
        if not np.array_equal(gen(batch, gpt2_ref["steps"],
                                  stop_at_eos=False), tokens):
            fail(f"phase 14a: batch {len(batch)}: pod 1's tokens differ "
                 "from the CPU float32 run's")
    del gen, res
    print(f"phase 14a federated pull ({card_label()}): GPT-2 revision A by "
          f"2 pods, each {FED_MESH} on [{dev}] * {FED_SLOTS}, pod 0 first; "
          f"pod 0 {fed0}; pod 1 {fed1} (pod 0 owns {len(mine0)} units, "
          f"{mine0_bytes:,} B, all over DCN); "
          f"CDN bytes {cdn} ({sum(cdn) / copy:.4f} x one copy); pod 1 peer "
          f"bytes {peer1:,} = own (swarm) + DCN; each pre-pass "
          f"{want} launches (rows) = the plan's whole-xorb units', "
          f"{prefixes} rejected; time_to_hbm_s "
          f"{[s['time_to_hbm_s'] for s in stats]}; files, digests and "
          f"greedy tokens (batch 1 and 4) the CPU's; phase wall "
          f"{time.monotonic() - wall0:.2f} s")
    for name in ("f0", "f1", "f14"):
        shutil.rmtree(work / name, ignore_errors=True)
    return launches


def hierarchy_phase(work: Path, url: str, cfg_a, pushed, dev) -> dict:
    """Phase 14b: the hierarchical distributor over GPT-2's units on
    ``hier_mesh(2, 2, [dev] * 4)``: every slot's gathered rows byte-equal
    to a CPU distribute of the same plan, then a fill of a fresh cache
    through the receipt kernels (one launch each per whole-xorb unit); a
    second round with one unit corrupted in flight rejects it. Returns the
    first fill's launches."""
    import torch

    from zest_tpu_torch.config import Config
    from zest_tpu_torch.parallel import (
        HierarchicalDistributor,
        HierarchicalPlan,
        hier_mesh,
    )
    from zest_tpu_torch.storage import XorbCache
    from zest_tpu_torch.transfer.pod import make_unit_verifier

    wall0 = time.monotonic()
    plan = HierarchicalPlan.build(gpt2_recs(Config(
        hf_home=work / "h14" / "hf", cache_dir=work / "h14" / "zest",
        endpoint=url), pushed.revision), 2, 2)
    want, prefixes = plan_launches(plan.flat, cfg_a)

    def fetch(a, corrupt=None):
        data = cfg_a.xorb_cache_path(a.hash_hex).read_bytes()[
            a.fetch_info.url_range_start:a.fetch_info.url_range_end]
        if a.hash_hex != corrupt:
            return data
        bad = bytearray(data)
        bad[len(bad) // 2] ^= 0xFF
        return bytes(bad)

    hd = HierarchicalDistributor(hier_mesh(2, 2, [dev] * 4))
    pool = hd.distribute(plan, fetch)
    stage = hd.stage_stats()
    cpu = HierarchicalDistributor(hier_mesh(2, 2, ["cpu"] * 4)).distribute(
        plan, fetch).replicas[0]
    for slot, replica in enumerate(pool.replicas):
        if replica.device != dev or not torch.equal(replica.cpu(), cpu):
            fail(f"phase 14b: slot {slot}'s rows differ from the CPU "
                 "distribute's")
    del cpu
    verify = make_unit_verifier(device=dev)
    victim = sorted(h for h in pool.layout.full_xorbs)[0]
    fills = []
    for name, corrupt in (("h14a", None), ("h14b", victim)):
        if corrupt is not None:
            del pool
            pool = hd.distribute(plan, lambda a: fetch(a, corrupt))
        cache = XorbCache(Config(hf_home=work / name / "hf",
                                 cache_dir=work / name / "zest"))
        reset_counters()
        fills.append((*pool.fill_cache(cache, verify=verify),
                      read_counters()))
    del pool
    torch.cuda.empty_cache()
    n = len(plan.flat.assignments)
    (f0, r0, launches), (f1, r1, _) = fills
    if (f0 + prefixes, r0) != (n, prefixes) or launches != want:
        fail(f"phase 14b: filled {f0}/{n}, rejected {r0} ({prefixes} "
             f"prefixes), launches (rows) {launches}; the plan's whole-xorb "
             f"units predict {want}")
    if (f1, r1) != (f0 - 1, r0 + 1):
        fail(f"phase 14b: the corrupted unit: filled {f1}/{n}, rejected "
             f"{r1}")
    print(f"phase 14b hierarchical distributor ({card_label()}): GPT-2's "
          f"{n} units over hier_mesh(2, 2, [{dev}] * 4), plan "
          f"{plan.summary()}; every slot's rows = the CPU distribute's; "
          f"fill {f0}/{n}, launches (rows) {launches} = the plan's "
          f"whole-xorb units'; one unit corrupted in flight: filled {f1}, "
          f"rejected {r1}; stage_stats (copies between slots of one card, "
          f"not a link) {stage}; phase wall "
          f"{time.monotonic() - wall0:.2f} s")
    for name in ("h14", "h14a", "h14b"):
        shutil.rmtree(work / name, ignore_errors=True)
    return {k: v[0] for k, v in launches.items()}


def within_block_bound(exact: bytes, got: bytes, phase: int) -> bool:
    """Whether ``got`` keeps the lossy tier's promise for the chunk
    ``exact`` (``transfer/lossy.py``) when both are read as float32 from
    byte ``phase``: the sub-float head and tail bytes verbatim and every
    value within its 256-value block's absmax / 127."""
    n = len(exact)
    nvals = (n - phase) // 4
    tail = phase + 4 * nvals
    if len(got) != n or exact[:phase] != got[:phase] \
            or exact[tail:] != got[tail:]:
        return False
    x = np.frombuffer(exact, "<f4", offset=phase, count=nvals)
    y = np.frombuffer(got, "<f4", offset=phase, count=nvals)
    if not (np.isfinite(x).all() and np.isfinite(y).all()):
        return False
    nb = -(-nvals // 256)
    pad = np.zeros((2, nb * 256), np.float64)
    pad[0, :nvals], pad[1, :nvals] = x, y
    blocks = pad.reshape(2, nb, 256)
    bound = np.abs(blocks[0]).max(axis=1, keepdims=True) / 127.0
    return bool((np.abs(blocks[1] - blocks[0]) <= bound * (1 + 1e-6)).all())


def squares_overflow(exact: bytes, phase: int) -> bool:
    """Whether the chunk ``exact`` read as float32 from byte ``phase`` has
    a sum of squares past float32's range: the codec then scores that
    reading's SNR infinite (or NaN) and can pick it over the float grid,
    a fault of the JAX package's codec that the port keeps."""
    x = np.frombuffer(exact, "<f4", offset=phase,
                      count=(len(exact) - phase) // 4)
    with np.errstate(over="ignore"):
        return bool(np.isinf(np.square(x).sum(dtype=np.float32)))


def container_phases(container: bytes) -> list:
    """Each chunk's byte phase in a ZQLS container as the codec recorded
    it, None for a chunk that rides verbatim."""
    from zest_tpu_torch.transfer.lossy import _CHDR, _HDR, KIND_QUANT

    pos, out = _HDR.size, []
    for _ in range(_HDR.unpack_from(container)[3]):
        kind, plen, _raw = _CHDR.unpack_from(container, pos)
        pos += _CHDR.size
        out.append(container[pos] if kind == KIND_QUANT else None)
        pos += plen
    return out


def overlay_faults(data: bytes, landed, data_start: int, rec,
                   staging) -> tuple[list, int, int]:
    """Holds a landing through the lossy overlay to the tier's promise,
    chunk by chunk (the push's content-defined cuts, in ``rec``'s order):
    each chunk of ``landed`` that differs from the file's ``data`` must be
    one that ``staging`` holds quantized, and must be within the block
    bound read at the byte phase its container records. That phase must
    be the file's float grid, but where the codec's SNR pick overflowed
    there (``squares_overflow``). Returns the file ranges of the chunks
    that break these rules, the count of chunks that moved, and the count
    of those whose container is off the grid."""
    from zest_tpu_torch.cas.chunking import cut_points

    phases, tables = [], {}
    for term in rec.terms:
        for c in range(term.range.start, term.range.end):
            hit = staging.get_with_range(term.hash_hex, c)
            phase = None
            if hit is not None:
                key = (term.hash_hex, hit[1])
                if key not in tables:
                    tables[key] = container_phases(hit[0])
                if c - hit[1] < len(tables[key]):
                    phase = tables[key][c - hit[1]]
            phases.append(phase)
    cuts = cut_points(data)
    if len(cuts) != len(phases):
        return [(0, len(data))], 0, 0
    faults, moved, off_grid, start = [], 0, 0, 0
    for end, phase in zip(cuts, phases):
        if landed[start:end] != data[start:end]:
            moved += 1
            if phase is None or not within_block_bound(
                    data[start:end], bytes(landed[start:end]), phase):
                faults.append((start, end))
            elif phase != (data_start - start) % 4:
                off_grid += 1
                if not squares_overflow(data[start:end], phase):
                    faults.append((start, end))
        start = end
    return faults, moved, off_grid


def lossy_phase(work: Path, url: str, ckpt: Path, pushed, dev) -> dict:
    """Phase 14c: the lossy tier. Four coop hosts of revision A's
    ``model.safetensors``, pod map ``LOSSY_PODS`` (each pod one slice),
    ``collective_lossy="dcn"``: quantized float units cross the pods into
    the staging overlays. Gates: lossy bytes and a bits-saved ratio in
    (0, 1) on every host, no ZQLS container in any xorb cache, the receipt
    kernels' rows those of the whole xorbs each host received byte-exact,
    a tree landed through host 1's overlay different from the exact tree,
    each chunk that moved staged quantized and within the block bound at
    the float grid (at its container's phase where the codec read it off
    the grid), and every host's file byte-identical once healed through
    the waterfall. Returns each kernel's launches in the round."""
    import torch

    from zest_tpu_torch.cas.compression import Scheme
    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.cas.xorb import XorbReader
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.loader import stage_cached_to_hbm
    from zest_tpu_torch.models.safetensors_io import parse_header_prefix
    from zest_tpu_torch.transfer import lossy
    from zest_tpu_torch.transfer.bridge import XetBridge
    from zest_tpu_torch.transfer.coop import CoopPlan, coop_round
    from zest_tpu_torch.transfer.dcn import DcnServer

    wall0 = time.monotonic()
    n = len(LOSSY_PODS)
    bridges, servers, addrs = [], [], {}
    for i in range(n):
        cfg = Config(hf_home=work / f"l14-{i}" / "hf",
                     cache_dir=work / f"l14-{i}" / "zest", endpoint=url,
                     dcn_port=0, coop_pods=LOSSY_PODS,
                     coop_topology=LOSSY_PODS, collective_lossy="dcn")
        b = XetBridge(cfg)
        b.authenticate(REPO, pushed.revision)
        bridges.append(b)
        servers.append(DcnServer(cfg, b.cache))
        addrs[i] = ("127.0.0.1", servers[-1].start())
    entry = next(e for e in HubClient(bridges[0].cfg).list_files(
        REPO, pushed.revision) if e.path == "model.safetensors")
    rec = bridges[0].get_reconstruction(entry.xet_hash)
    results, errors = [None] * n, []

    def host(i):
        try:
            results[i] = coop_round(bridges[i], [rec], i, n, addrs,
                                    server=servers[i], device=dev)
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    reset_counters()
    threads = [threading.Thread(target=host, args=(i,)) for i in range(n)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    round_s = time.monotonic() - t0
    launches = read_counters()
    for s in servers:
        s.shutdown()
    if errors:
        raise errors[0]

    # The whole xorbs each host received byte-exact from a peer (owned by
    # another host, cached under the full key): their receipts' rows.
    plan = CoopPlan.build([rec], n)
    want = {"blake3_chunks": 0, "bg4_fused_verify": 0}
    for i, (b, r) in enumerate(zip(bridges, results)):
        ex, cx = r["exchange"], r.get("collective") or {}
        if cx.get("lossy") != "dcn" or cx.get("aborted") or r["fallbacks"] \
                or ex["verify_rejected"] or not ex.get("lossy_bytes") \
                or not 0 < ex.get("bits_saved_ratio", 0) < 1:
            fail(f"phase 14c host {i}: collective {cx}, fallbacks "
                 f"{r['fallbacks']}, exchange {ex}")
        for path in (b.cfg.cache_dir / "xorbs").rglob("*"):
            if path.is_file() and lossy.is_lossy_container(
                    path.read_bytes()[:64]):
                fail(f"phase 14c host {i}: a ZQLS container in the cache: "
                     f"{path}")
        mine = {hh for hh, _fi in plan.for_host(i)}
        for hh in rec.fetch_info:
            full = b.cfg.xorb_cache_path(hh)
            if hh in mine or not full.exists():
                continue
            schemes = XorbReader(full.read_bytes()).chunk_schemes
            bg4 = int((schemes == int(Scheme.BG4_LZ4)).sum())
            want["bg4_fused_verify"] += bg4
            want["blake3_chunks"] += len(schemes) - bg4
    if {k: launches[k][1] for k in want} != want \
            or launches["bg4_regroup"][0] \
            or not sum(launches[k][0] for k in want):
        fail(f"phase 14c: kernel launches (rows) {launches}; the whole "
             f"xorbs received byte-exact hold {want} chunks")

    # A landing with no file sink reads host 1's overlay; the header
    # comes from the file itself. Its bytes in file order against the
    # file's: every chunk that moved is one host 1 holds quantized, within
    # the block bound at the phase its container records, which is the
    # float grid but for the codec's overflowed picks (counted).
    data = (ckpt / "model.safetensors").read_bytes()
    header = parse_header_prefix(data)
    tree, _ = stage_cached_to_hbm(bridges[1], [(rec, header)], dev)
    landed = bytearray(data)
    for name, t in tree.items():
        lo, hi = header.tensors[name].file_range(header.data_start)
        landed[lo:hi] = t.cpu().contiguous().view(torch.uint8).numpy() \
            .tobytes()
    n_vals = sum(t.numel() for t in tree.values())
    del tree
    torch.cuda.empty_cache()
    faults, moved, off_grid = overlay_faults(
        data, landed, header.data_start, rec,
        lossy.staging_for(bridges[1].cfg.cache_dir))
    if faults:
        fail(f"phase 14c: {len(faults)} moved chunks not staged "
             "quantized, past the block bound at their container's phase, "
             "or read off the float grid with no overflow there: the "
             f"first {faults[:4]}")
    if not moved:
        fail("phase 14c: the overlay landing is the exact tree: the lossy "
             "tier never engaged")
    diff = np.frombuffer(landed, np.uint8) != np.frombuffer(data, np.uint8)
    del landed
    staged = [lossy.staging_for(b.cfg.cache_dir).units() for b in bridges]
    for i, b in enumerate(bridges):
        out = work / f"l14-{i}" / "model.safetensors"
        b.reconstruct_to_file(entry.xet_hash, out)
        if out.read_bytes() != data:
            fail(f"phase 14c host {i}: the healed file differs")
        b.close()
    lossy.reset_stagings()
    ex = [r["exchange"] for r in results]
    print(f"phase 14c lossy tier ({card_label()}): {n} coop hosts, pods "
          f"{LOSSY_PODS}, collective_lossy=dcn, round {round_s:.2f} s; "
          f"lossy_bytes {[e['lossy_bytes'] for e in ex]}, bits_saved_ratio "
          f"{[e['bits_saved_ratio'] for e in ex]}, wire "
          f"{[e['wire_bytes'] for e in ex]}, links "
          f"{[r['collective']['link_bytes'] for r in results]}; staged "
          f"units {staged}; no ZQLS container in any cache; receipt "
          f"launches (rows) {launches} = the byte-exact whole xorbs'; host "
          f"1's overlay landing ({n_vals:,} values) moved "
          f"{int(diff.sum()):,} bytes in {moved} chunks, each staged "
          "quantized and within its block bound at its container's phase, "
          f"{off_grid} of them off the float grid where that reading "
          "overflows float32; every host's file byte-identical once "
          "healed; phase wall "
          f"{time.monotonic() - wall0:.2f} s")
    for i in range(n):
        shutil.rmtree(work / f"l14-{i}", ignore_errors=True)
    return {k: v[0] for k, v in launches.items()}


TENANT_CDN_SLACK = 1.02  # the duplicate-fetch gate: CDN bytes / one copy


class first_layer_hook:
    """Within the block, ``fn()`` runs right after each streaming landing
    of ``transfer.pull`` reports its first layer resident (the landing's
    ``on_first_layer``): where phase 16a fires a tenant's cancel token."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from zest_tpu_torch.transfer import pull as pull_mod

        self.real = real = pull_mod.stage_cached_to_hbm
        fn = self.fn

        def hooked(*a, on_first_layer=None, **k):
            def fire():
                if on_first_layer is not None:
                    on_first_layer()
                fn()
            return real(*a, on_first_layer=fire, **k)

        pull_mod.stage_cached_to_hbm = hooked
        return self

    def __exit__(self, *exc):
        from zest_tpu_torch.transfer import pull as pull_mod

        pull_mod.stage_cached_to_hbm = self.real


def debug_surface(base: str, get, cancelled_id: str, tth: float) -> str:
    """Phase 16b's daemon after its pulls: ``GET /v1/debug?tail=8`` has
    a recorder tail holding the queued pull's cancel, a landing block
    with the running pull's ``time_to_hbm_s`` and a telemetry block;
    ``GET /v1/trace`` with no tracer armed answers the note; ``GET
    /v1/metrics?scope=pod`` with no pod peers is this host's exposition,
    one host."""
    import urllib.request

    from zest_tpu_torch.telemetry import fleet

    debug = get("/v1/debug?tail=8")
    events = debug.get("recorder", {}).get("events", [])
    if not any(e["kind"] == "pull_cancelled"
               and e.get("session") == cancelled_id for e in events):
        fail(f"phase 16b: /v1/debug's tail has no cancel of "
             f"{cancelled_id}: {[e['kind'] for e in events]}")
    landing = debug.get("landing") or {}
    if landing.get("time_to_hbm_s") != tth or "telemetry" not in debug:
        fail(f"phase 16b: /v1/debug landing {landing}, telemetry "
             f"{debug.get('telemetry')}")
    trace = get("/v1/trace")
    if trace.get("traceEvents") or "no tracer armed" not in trace.get(
            "otherData", {}).get("note", ""):
        fail(f"phase 16b: /v1/trace with no tracer {str(trace)[:300]}")
    with urllib.request.urlopen(base + "/v1/metrics?scope=pod",
                                timeout=60) as r:
        pod = fleet.parse_prometheus(r.read().decode())
    with urllib.request.urlopen(base + "/v1/metrics", timeout=60) as r:
        local = fleet.parse_prometheus(r.read().decode())
    pulls = pod.get("zest_pulls_total", {}).get("samples")
    if pod["zest_pod_hosts"]["samples"] != {(): 1.0} or not pulls \
            or pulls != local["zest_pulls_total"]["samples"]:
        fail(f"phase 16b: pod-scope metrics {pulls} vs this host's "
             f"{local.get('zest_pulls_total')}")
    return (f"/v1/debug tail {[e['kind'] for e in events]}, landing "
            f"time_to_hbm_s {landing['time_to_hbm_s']}; /v1/trace "
            f"unarmed; /v1/metrics?scope=pod 1 host, pulls "
            f"{ {dict(k).get('outcome'): v for k, v in pulls.items()} }")


def cache_entries(cfg) -> dict[str, set[str]]:
    """xorb hash → the names of its entries in ``cfg``'s cache (the full
    one and ``{hash}.{start}`` partial ones)."""
    out: dict[str, set[str]] = {}
    root = cfg.xorb_cache_dir()
    for f in root.rglob("*"):
        if f.is_file() and not f.name.startswith(".tmp-"):
            out.setdefault(f.name.split(".", 1)[0], set()).add(f.name)
    return out


def tenancy_phase(work: Path, url: str, cfg_a, ckpt: Path, pushed,
                  digest: str, swap_ref: dict, seed: int, dev) -> dict:
    """Phase 16: the multi-tenant pull service, on GPT-2 revisions A
    (``pushed``, CPU digest ``digest``, weights from ``seed``), B
    (``swap_ref``) and C (pushed here) from node A's publisher (``cfg_a``),
    on fresh nodes. Returns the kernels' launches by path
    (``tenancy`` 16a, ``tenancy_daemon`` 16b's ``serve`` process,
    ``tenancy_swap`` 16c: 0 each; ``push_tenancy``, C's push: kernel #1
    as on every push).

    16a, in-process on ``cuda:0`` over one fresh tenancy state
    (``tenant_max_pulls=2``, ``tenant_queue=1``): tenants t0 and t1 pull A
    at once; every CDN unit is fetched once (CDN fetches = A's distinct
    units, CDN bytes ≤ 1.02 × one copy), the singleflight table records
    dedupe hits, both trees have the CPU digest and both sessions end ok
    under their tenants. Then t2 pulls B and its token fires when its
    first layer is resident: the pull ends ``cancelled``, the card's
    allocation returns to its level before t2 began, no complete-named
    safetensors file is in t2's snapshot, no session holds a slot, and a
    re-pull of B (a second HF dir over the same cache) lands B's digest.

    16b, a ``serve --device cuda`` process with ``ZEST_TENANT_MAX_PULLS=1``
    and ``ZEST_TENANT_QUEUE=1``, started by ``api.daemon.ZestServer`` and
    read through ``api.client.ZestClient``: three ``POST /v1/pull`` of A
    with ``device: "cuda"``. One runs; one shows phase ``queued`` in
    ``GET /v1/pulls`` and ends ``cancelled`` after ``DELETE
    /v1/pulls/<id>``; the third gets 429 with ``Retry-After`` before any
    SSE byte. The running pull's ``done`` carries ``time_to_hbm_s`` > 0
    and 16a's landed bytes, its files equal the checkpoint, and ``ps
    --json`` lists both sessions terminal; ``ZestServer.stop()`` ends the
    process with exit 0.

    16c, on 16a's node: revision C (``REDRAWN_C`` drawn again from
    ``seed + 2``; B's delta reads every xorb of A, C's leaves some out) is
    pushed, outside the counted path, and hot-swapped over t0's A tree
    (``base_params``); then the disk watermark is armed below the cache's
    bytes and an eviction pass run. The tree pin is C's (it replaced the
    earlier landings' pins), so exactly the entries outside C's tree are
    evicted, among them every xorb of A alone (at least one), none of
    which stays pinned, and no pinned entry leaves the disk; the swap's
    5b gates hold (fetched ≤ changed + stale, C's CPU digest).

    ``huggingface_hub`` (``zest_tpu_torch.enable()``) is held on the CPU
    only: the card's machine has neither it nor ``requests``, so this
    phase drives ``ZestServer`` and ``ZestClient`` directly."""
    import dataclasses
    import gc
    import urllib.error
    import urllib.request
    from types import SimpleNamespace

    import torch

    from zest_tpu_torch import telemetry
    from zest_tpu_torch.api.client import ZestClient
    from zest_tpu_torch.api.daemon import ZestServer
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.parallel.plan import collect_units
    from zest_tpu_torch.transfer import tenancy
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint
    from zest_tpu_torch.transfer.tenancy import CancelToken, PullCancelled

    wall0 = time.monotonic()
    sha_a, sha_b, digest_b = (pushed.revision, swap_ref["revision"],
                              swap_ref["digest"])
    session = telemetry.session
    tenancy.reset()  # the phase's own shared state, on fresh nodes
    session.reset()
    reset_counters()

    # ── 16a ──
    cfg = Config(hf_home=work / "t" / "hf", cache_dir=work / "t" / "zest",
                 endpoint=url, tenant_max_pulls=2, tenant_queue=1)
    recs_a, recs_b = gpt2_recs(cfg, sha_a), gpt2_recs(cfg, sha_b)
    units_a = collect_units(recs_a)
    one_copy = pushed.new_xorb_bytes
    out: dict = {}
    barrier = threading.Barrier(2)

    def tenant_pull(tenant):
        barrier.wait()
        out[tenant] = pull_model(cfg, REPO, revision=sha_a, device=dev,
                                 tenant=tenant, log=lambda *a, **k: None)

    t0 = time.monotonic()
    threads = [threading.Thread(target=tenant_pull, args=(t,))
               for t in ("t0", "t1")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    wall_a = time.monotonic() - t0
    if set(out) != {"t0", "t1"}:
        fail(f"phase 16a: tenants {sorted(out)} finished, not t0 and t1")
    cdn_fetches = sum(r.stats["fetch"]["xorbs"]["cdn"] for r in out.values())
    cdn_bytes = sum(r.stats["fetch"]["bytes"]["cdn"] for r in out.values())
    dedupe = tenancy.state(cfg).flights.summary()
    if cdn_fetches != len(units_a) or cdn_bytes > TENANT_CDN_SLACK * one_copy:
        fail(f"phase 16a: {cdn_fetches} CDN fetches for {len(units_a)} "
             f"units, {cdn_bytes:,} CDN bytes for one copy {one_copy:,}")
    if not dedupe["dedupe_hits"] > 0:
        fail(f"phase 16a: no singleflight dedupe hit: {dedupe}")
    for tenant, res in out.items():
        check_tree(f"phase 16a {tenant}", res, digest, dev)
    ends = sorted((s.tenant, s.status) for s in session.SESSIONS.recent())
    if ends != [("t0", "ok"), ("t1", "ok")]:
        fail(f"phase 16a: sessions {ends}")
    tth = [out[t].stats["time_to_hbm_s"] for t in ("t0", "t1")]
    landed_bytes = out["t0"].stats["hbm"]["bytes"]
    t1_tree = out.pop("t1")
    del t1_tree
    gc.collect()
    torch.cuda.synchronize()
    base_alloc = torch.cuda.memory_allocated(dev)
    token = CancelToken()
    fired_at: list[float] = []

    def fire():
        if not token.fired:
            fired_at.append(time.monotonic())
            token.cancel("phase 16a: first layer committed")

    t0 = time.monotonic()
    cancelled = False
    with first_layer_hook(fire):
        try:
            pull_model(cfg, REPO, revision=sha_b, device=dev, tenant="t2",
                       cancel=token, log=lambda *a, **k: None)
        except PullCancelled:
            cancelled = True
    t_end = time.monotonic()
    if not cancelled or not fired_at:
        fail(f"phase 16a: t2 was not cancelled mid-landing (cancelled "
             f"{cancelled}, fired {bool(fired_at)})")
    cancel_to_release = t_end - fired_at[0]
    gc.collect()
    torch.cuda.synchronize()
    after_alloc = torch.cuda.memory_allocated(dev)
    t2 = session.SESSIONS.recent()[0].snapshot()
    snap_b = cfg.model_snapshot_dir(REPO, sha_b)
    complete = [f.name for f in snap_b.rglob("*.safetensors")] \
        if snap_b.exists() else []
    summary = tenancy.summary(cfg)
    if (t2["tenant"], t2["status"]) != ("t2", "cancelled"):
        fail(f"phase 16a: t2's session {t2}")
    if after_alloc != base_alloc:
        fail(f"phase 16a: {after_alloc:,} B allocated after the cancel, "
             f"{base_alloc:,} B before t2 began")
    if complete:
        fail(f"phase 16a: complete-named files in t2's snapshot: {complete}")
    if summary["active"] or summary["queued"]:
        fail(f"phase 16a: tenancy after the cancel {summary}")
    repull = pull_model(dataclasses.replace(cfg, hf_home=work / "t" / "hf2"),
                        REPO, revision=sha_b, device=dev, tenant="t2",
                        log=lambda *a, **k: None)
    check_tree("phase 16a re-pull", repull, digest_b, dev)
    del repull
    gc.collect()
    print(f"phase 16a tenants ({card_label()}): t0 and t1 pulled A at once "
          f"in {wall_a:.3f} s (time_to_hbm_s {tth[0]} / {tth[1]}); "
          f"{cdn_fetches} CDN fetches for {len(units_a)} units, "
          f"{cdn_bytes:,} CDN bytes = {cdn_bytes / one_copy:.4f} x one copy; "
          f"singleflight {dedupe}; digests equal; t2 cancelled "
          f"{fired_at[0] - t0:.3f} s into its pull, released "
          f"{cancel_to_release:.3f} s after the cancel; allocation "
          f"{after_alloc:,} B = before t2; re-pull of B: digest equal")
    launches = {"tenancy": read_counters()}

    # ── 16b ──
    reset_counters()
    root = Path(__file__).resolve().parent
    env = dict(os.environ, HF_HOME=str(work / "u" / "hf"),
               ZEST_CACHE_DIR=str(work / "u" / "zest"), HF_ENDPOINT=url,
               ZEST_HTTP_PORT="0", ZEST_LISTEN_PORT="0", ZEST_DCN_PORT="0",
               ZEST_TENANT_MAX_PULLS="1", ZEST_TENANT_QUEUE="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (str(root), os.environ.get("PYTHONPATH"))
                   if p))
    env.pop("ZEST_FAULTS", None)
    cfg_u = Config.load(env)
    daemon = ZestServer(cfg_u, env=env, args=["--device", dev.type])
    t0 = time.monotonic()
    daemon.ensure_running()
    start_s = time.monotonic() - t0
    stopped = False
    try:
        base = f"http://127.0.0.1:{cfg_u.effective_http_port()}"
        status = ZestClient(cfg_u).status()
        tn = status.get("tenancy") or {}
        if (tn.get("max_pulls"), tn.get("queue_cap")) != (1, 1):
            fail(f"phase 16b: the daemon's tenancy block {tn}")
        kernels0 = status["kernels"]

        def get(path):
            with urllib.request.urlopen(base + path, timeout=60) as r:
                return json.loads(r.read())

        def post_pull(tenant):
            return urllib.request.Request(
                base + "/v1/pull", method="POST",
                headers={"Content-Type": "application/json"},
                data=json.dumps({"repo_id": REPO, "revision": sha_a,
                                 "device": dev.type,
                                 "tenant": tenant}).encode())

        streams: dict = {}

        def stream(tenant):
            with urllib.request.urlopen(post_pull(tenant),
                                        timeout=600) as r:
                streams[tenant] = [json.loads(ln[6:]) for ln in r
                                   if ln.startswith(b"data: ")]

        def wait_for(pred, label):
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                doc = get("/v1/pulls")
                rows = pred(doc)
                if rows:
                    return rows
                time.sleep(0.01)
            fail(f"phase 16b: {label} never showed in /v1/pulls: {doc}")

        t_run = threading.Thread(target=stream, args=("u0",))
        t_run.start()
        running = wait_for(lambda d: [s for s in d["active"]
                                      if s.get("tenant") == "u0"
                                      and s["phase"] != "queued"],
                           "the running pull")
        t_q = threading.Thread(target=stream, args=("u1",))
        t_q.start()
        queued = wait_for(lambda d: [s for s in d["active"]
                                     if s.get("tenant") == "u1"
                                     and s["phase"] == "queued"],
                          "the queued pull")
        code = retry = body = None
        try:
            with urllib.request.urlopen(post_pull("u2"), timeout=60) as r:
                code, body = r.status, r.read(64)
        except urllib.error.HTTPError as exc:
            code, retry = exc.code, exc.headers.get("Retry-After")
            body = exc.read()
        if code != 429 or not retry or int(retry) < 1 \
                or body.startswith(b"data:"):
            fail(f"phase 16b: the third pull got {code}, Retry-After "
                 f"{retry}: {body[:200]!r}")
        still = [s for s in get("/v1/pulls")["active"]
                 if s["id"] == running[0]["id"] and s["phase"] != "queued"]
        if not still:
            fail("phase 16b: the running pull ended before the queue "
                 "filled")
        req = urllib.request.Request(
            f"{base}/v1/pulls/{queued[0]['id']}", method="DELETE")
        with urllib.request.urlopen(req, timeout=60) as r:
            deleted = json.loads(r.read())
        t_q.join(300)
        t_run.join(600)
        done, gone = streams.get("u0", []), streams.get("u1", [])
        if not done or done[-1]["event"] != "done":
            fail(f"phase 16b: the running pull's stream {done[-3:]}")
        if not gone or gone[-1]["event"] != "cancelled":
            fail(f"phase 16b: the queued pull's stream {gone[-3:]}")
        st = done[-1]["stats"]
        if not st["time_to_hbm_s"] > 0 or st["hbm"]["bytes"] != landed_bytes:
            fail(f"phase 16b: done carries time_to_hbm_s "
                 f"{st.get('time_to_hbm_s')}, {st['hbm']['bytes']:,} B "
                 f"landed (16a {landed_bytes:,} B)")
        check_files("phase 16b", SimpleNamespace(
            snapshot_dir=Path(done[-1]["snapshot_dir"])), ckpt)
        ps = subprocess.run(
            [sys.executable, "-m", "zest_tpu_torch", "ps", "--json"],
            env=env, capture_output=True, text=True, timeout=120)
        doc = json.loads(ps.stdout) if ps.returncode == 0 else {}
        ends = {s["id"]: s["status"] for s in doc.get("recent", [])}
        want = {running[0]["id"]: "ok", queued[0]["id"]: "cancelled"}
        if ps.returncode or doc.get("active") or ends != want:
            fail(f"phase 16b: ps --json exit {ps.returncode}: {ends} "
                 f"(want {want}) {ps.stderr[-500:]}")
        debug_note = debug_surface(base, get, queued[0]["id"],
                                   st["time_to_hbm_s"])
        kernels = ZestClient(cfg_u).status()["kernels"]
        launches["tenancy_daemon"] = {
            k: [c["launches"] - kernels0[k]["launches"],
                c["rows"] - kernels0[k]["rows"]]
            for k, c in kernels.items()}
        rc = daemon.stop()
        stopped = True
        if rc != 0:
            fail(f"phase 16b: the daemon exited {rc}")
    finally:
        if not stopped:
            daemon.stop()
    print(f"phase 16b daemon: ready in {start_s:.2f} s; u0 ran "
          f"(time_to_hbm_s {st['time_to_hbm_s']}, {st['hbm']['bytes']:,} B "
          f"landed), u1 {queued[0]['phase']} then {deleted['status']} → "
          f"{gone[-1]['event']}, u2 {code} Retry-After {retry} before the "
          f"stream; files exact; ps --json {sorted(ends.values())}; "
          f"{debug_note}; ZestServer.stop() exit 0")

    # ── 16c ──
    ckpt_c = work / "checkpoint-c"
    ckpt_c.mkdir()
    shutil.copy(ckpt / "config.json", ckpt_c / "config.json")
    tensors = gpt2_checkpoint(seed, GPT2_CONFIG)  # A's, as ckpt holds them
    write_safetensors(ckpt_c / "model.safetensors", revision_b(
        tensors, seed + 2, [n for n in tensors if n.startswith(REDRAWN_C)]))
    del tensors
    reset_counters()
    pushed_c = push_checkpoint(cfg_a, REPO, ckpt_c, base_revision=sha_a,
                               device=dev, notify=False,
                               log=lambda *a, **k: None)
    push_c = read_counters()
    n, rows = push_c["blake3_chunks"]
    # (On the CPU, where phase 16 is rehearsed, a push launches nothing.)
    if dev.type == "cuda" and (n < 1 or rows != pushed_c.minted_chunks):
        fail(f"phase 16c: C's push hashed {rows} chunks in {n} launches; "
             f"it minted {pushed_c.minted_chunks}")
    sha_c = pushed_c.revision
    digest_c = params_digest(load_checkpoint(ckpt_c, "cpu"))
    reset_counters()
    tree = out.pop("t0").params
    t0 = time.monotonic()
    swap = pull_model(cfg, REPO, revision=sha_c, device=dev,
                      base_params=tree, base_revision=sha_a, tenant="t0",
                      log=lambda *a, **k: None)
    swap_s = time.monotonic() - t0
    d = swap.stats.get("delta") or {}
    stale = d.get("stale_bytes", 0)
    if tree or "swap" not in swap.stats["hbm"] \
            or not d["fetched_bytes"] <= d["changed_bytes"] + stale:
        fail(f"phase 16c: swap {swap.stats['hbm'].get('swap')}, delta "
             f"{ {k: v for k, v in d.items() if k != 'files'} }, "
             f"{len(tree)} base tensors left")
    check_tree("phase 16c", swap, digest_c, dev)
    hashes_a = {h for r in recs_a for h in r.fetch_info}
    hashes_b = {h for r in recs_b for h in r.fetch_info}
    hashes_c = {h for r in gpt2_recs(cfg, sha_c) for h in r.fetch_info}
    a_only = hashes_a - hashes_c
    st16 = tenancy.state(cfg)
    if not all(st16.pins.pinned(h) for h in hashes_c) \
            or any(st16.pins.pinned(h) for h in a_only):
        fail(f"phase 16c: the tree pin is not C's: {st16.pins.summary()}")
    before = cache_entries(cfg)
    pinned = {h for h in before if st16.pins.pinned(h)}
    usage = st16.evictor.usage_bytes()
    armed = dataclasses.replace(cfg, tenant_disk_high=usage - 1,
                                tenant_disk_low=1)
    st_armed = tenancy.state(armed)
    freed = st_armed.evictor.maybe_evict(force=True)
    after = cache_entries(cfg)
    evicted = {h for h in before if h not in after}
    pinned_lost = sorted(h for h in pinned if before[h] != after.get(h))
    b_only = hashes_b - hashes_c
    if (not a_only or not a_only <= set(before) or not a_only <= evicted
            or evicted != set(before) - pinned
            or not evicted <= a_only | b_only or pinned_lost):
        fail(f"phase 16c: evicted {len(evicted)} xorbs, {len(a_only)} of A "
             f"alone ({len(a_only & evicted)} evicted), {len(b_only)} of B "
             f"not in C, {len(pinned)} pinned, pinned entries gone "
             f"{pinned_lost}")
    launches["tenancy_swap"] = read_counters()
    swap_st = swap.stats
    del swap, tree
    gc.collect()
    print(f"phase 16c swap + eviction: C over t0's A in {swap_s:.3f} s "
          f"(time_to_swap_s {swap_st['time_to_swap_s']}, fetched "
          f"{d['fetched_bytes']:,} B, changed {d['changed_bytes']:,} B, "
          f"reused {swap_st['hbm']['swap']['reused_tensors']} tensors), "
          f"digest equal; C's tree pins {len(pinned)} xorbs, "
          f"{len(a_only)} xorbs of A alone; watermark {usage - 1:,} B: "
          f"evicted {len(evicted)} xorbs ({freed:,} B: A alone "
          f"{len(evicted & a_only)}, B's not in C "
          f"{len(evicted & b_only)}), "
          f"{st_armed.evictor.summary()['pinned_survivals']} pinned "
          "survivals, no pinned entry gone")
    for path, counts in launches.items():
        if any(n for n, _rows in counts.values()):
            fail(f"phase 16: kernel launches on {path}: {counts}")
    shutil.rmtree(work / "t")
    shutil.rmtree(work / "u")
    shutil.rmtree(ckpt_c)
    tenancy.reset()
    print(f"phase 16 wall {time.monotonic() - wall0:.2f} s; kernel "
          f"[launches, rows] by path {launches}, C's push {push_c}")
    launches["push_tenancy"] = push_c
    return {path: {k: n for k, (n, _rows) in counts.items()}
            for path, counts in launches.items()}


# Phase 17: the self-healing control plane. The reference's own knobs make
# its rules fire in seconds: a 1 s anomaly window, the sampler at 20 Hz
# (the engine's ring and pool rules compare two ticks, and a landing from
# the cache lasts well under a second), 2048 samples a series (the
# phase's ~100 s: 17a integrates its rate series from the sampler's
# start), a straggler patience of 1 (the first firing aborts the
# exchange), and a token back every second (17a's two pulls, then 17c's
# rush, each get a hedge token within seconds of the last).
HEAL_ENV = {"ZEST_ANOMALY_WINDOW_S": "1", "ZEST_TIMELINE_HZ": "20",
            "ZEST_TIMELINE_SAMPLES": "2048", "ZEST_REMEDIATE_PATIENCE": "1",
            "ZEST_REMEDIATE_RATE_S": "1"}
# 17a: each seeder response sleeps this long, under the peer io-timeout
# floor (2 s, p2p.health.io_timeout): no request times out, so nothing
# strikes the seeder; only the stall detector sees it.
HEAL_STALL_S = 1.5
# 17c: a landing ring small enough to stall on GPT-2's 9.4 MB tensors.
HEAL_RING = 4 * 1024 * 1024
# 17c: the pool's trees: Llama-3.2-1B's published width, depth cut 16 → 2
# (GPT-2 is not a pool family: POOL_FAMILIES), landed with a sleep after
# each flush so that a decode waits at its layer gates.
HEAL_POOL_LAYERS = 2
HEAL_LAND_DELAY_S = 0.4


def decision_counts() -> tuple[int, dict]:
    """``(engine id, {(action, outcome): n})`` of the remediation engine
    now in the process (``(0, {})`` before the first pull starts one)."""
    from zest_tpu_torch import telemetry

    eng = telemetry.remediate.ENGINE
    if eng is None:
        return 0, {}
    with eng._lock:
        return id(eng), dict(eng.counts)


class PhaseLog:
    """Prints, at each mark, the wall seconds since the previous mark and
    the remediation engine's decisions made in them, by action and
    outcome: the engine is on by default, so every phase shows what it
    decided there. ``walls`` keeps each mark's seconds."""

    def __init__(self):
        self.eng, self.last = decision_counts()
        self.t = time.monotonic()
        self.walls: dict[str, float] = {}

    def mark(self, label: str) -> dict:
        t = time.monotonic()
        self.walls[label] = round(t - self.t, 2)
        self.t = t
        eng, now = decision_counts()
        last = self.last if eng == self.eng else {}
        delta = {f"{a}/{o}": n - last.get((a, o), 0)
                 for (a, o), n in sorted(now.items())
                 if n != last.get((a, o), 0)}
        self.eng, self.last = eng, now
        print(f"{label} wall {self.walls[label]:.2f} s; remediation "
              f"decisions: {delta or 'none'}")
        return delta


def wait_decision(match, label: str, timeout: float = 5.0) -> dict:
    """The first decision in the engine's log that ``match``\\ es, waited
    for over the sampler's ticks."""
    from zest_tpu_torch import telemetry

    deadline = time.monotonic() + timeout
    while True:
        for e in telemetry.remediate.payload(limit=256)["recent"]:
            if match(e):
                return e
        if time.monotonic() > deadline:
            fail(f"{label}: no matching decision in "
                 f"{telemetry.remediate.payload(limit=256)['recent']}")
        time.sleep(0.05)


def wait_ticks(n: int = 2) -> None:
    """Until the sampler has run ``n`` more passes."""
    from zest_tpu_torch import telemetry

    store = telemetry.timeline.STORE
    want = store.ticks + n
    deadline = time.monotonic() + 10
    while store.ticks < want:
        if time.monotonic() > deadline:
            fail("phase 17: the timeline sampler stopped ticking")
        time.sleep(0.02)


def fetch_totals() -> dict[str, float]:
    """``zest_fetch_bytes_total`` by source, as the sampler reads it."""
    from zest_tpu_torch import telemetry

    for m in telemetry.REGISTRY.metrics():
        if m.name == "zest_fetch_bytes_total":
            out: dict[str, float] = {}
            for labels, v in m.samples():
                out[labels["source"]] = out.get(labels["source"], 0.0) + v
            return out
    return {}


def heal_pull(work: Path, url: str, cfg_b, ckpt: Path, pushed,
              digest: str, totals0: dict, dev) -> dict:
    """17a: a fresh node pulls revision A onto the card with node B's
    cache seeding it as its own process (phase 8a's seeder) under
    ``seeder_stall``. The detector fires ``stall`` (or
    ``throughput_collapse``) on the pull's session and the engine executes
    a hedge on its bridge: it arms the bridge, and nothing more, since a
    landing's unit fetches never hedge (in both packages); the tree lands
    with phase 4's digest and the ring gauges are sampled while it lands.
    Then a second fresh node pulls A's files only (``land=False``) from
    the same stalled seeder, one fetch at a time: the first fetch stalls,
    the engine arms that pull's hedge, and every later term fetch is raced
    by the CDN after the hedge's head start: ``hedges`` and ``hedges_won``
    at least 1, CDN bytes, files equal to phase 4's. Every
    ``fetch.<tier>_bps`` series integrates to its counter's delta since
    the sampler started (``totals0``)."""
    from zest_tpu_torch import telemetry
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.swarm import SwarmDownloader

    tl = telemetry.timeline
    cfg = Config(hf_home=work / "h17a" / "hf",
                 cache_dir=work / "h17a" / "zest", endpoint=url,
                 listen_port=0)
    # The files-only node fetches one term at a time: the seeder serves
    # one response at a time anyway, and a wider pool would start every
    # fetch before the first stall is seen.
    cfg_f = Config(hf_home=work / "h17f" / "hf",
                   cache_dir=work / "h17f" / "zest", endpoint=url,
                   listen_port=0, max_concurrent_downloads=1)
    seeder = Seeder("phase 17a", cfg_b,
                    ZEST_FAULTS=f"seeder_stall:1.0@{HEAL_STALL_S}")

    def stalled_pull(c, **kw):
        swarm = SwarmDownloader(c)
        swarm.add_direct_peer("127.0.0.1", seeder.port)
        try:
            return pull_model(c, REPO, revision=pushed.revision,
                              swarm=swarm, **kw)
        finally:
            swarm.close()

    off0 = tl.STORE._wall_offset
    reset_counters()
    try:
        t0 = time.time()
        res = stalled_pull(cfg, device=dev)
        t1 = time.time()
        sess = telemetry.session.SESSIONS.recent()[0]
        res_f = stalled_pull(cfg_f, land=False)
        t2 = time.time()
        sess_f = telemetry.session.SESSIONS.recent()[0]
    finally:
        served = seeder.stop()
    launches = read_counters()
    check_files("phase 17a", res, ckpt)
    check_tree("phase 17a", res, digest, dev)
    check_files("phase 17a files", res_f, ckpt)
    hedges = {}
    for label, s_ in (("device", sess), ("files", sess_f)):
        kinds = set(s_.anomalies) & {tl.ANOMALY_STALL, tl.ANOMALY_COLLAPSE}
        if not kinds:
            fail(f"phase 17a: no stall or collapse on the {label} pull's "
                 f"session: {s_.anomalies}")
        hedge = wait_decision(
            lambda e, sid=s_.id: e["action"] == "hedge"
            and e["session"] == sid, "phase 17a")
        if hedge["outcome"] != "success" \
                or not hedge["detail"].get("armed"):
            fail(f"phase 17a: the {label} pull's hedge decision {hedge}")
        hedges[label] = (sorted(kinds)[0], hedge)
    kind, hedge = hedges["device"]
    fetch_f = res_f.stats["fetch"]
    resil = fetch_f["resilience"]
    if resil["hedges"] < 1 or resil["hedges_won"] < 1 \
            or fetch_f["bytes"].get("cdn", 0) <= 0:
        fail(f"phase 17a: the files pull's hedge raced nothing: bytes "
             f"{fetch_f['bytes']}, resilience {resil}")
    wait_ticks(2)  # the after-snapshot settles, the counters' last look
    if not hedge["before"] or not hedge["after"]:
        fail(f"phase 17a: the hedge carries no series: before "
             f"{hedge['before']}, after {hedge['after']}")
    doc = tl.payload()
    for name in ("ring.in_use_bytes", "ring.stalls"):
        s = doc["series"].get(name, {}).get("samples", [])
        if not [t for t, _v in s if t0 <= t <= t1]:
            fail(f"phase 17a: {name} was not sampled while the landing "
                 f"ran ({len(s)} samples)")
    totals = fetch_totals()
    # Where the wall clock moved against the monotonic one by more than
    # the store's step (1 ms), the stamps followed it: one interval each
    # took that move.
    shift = abs(tl.STORE._wall_offset - off0)
    ints = {}
    for name, s in doc["series"].items():
        if not (name.startswith("fetch.") and name.endswith("_bps")):
            continue
        tier = name[len("fetch."):-len("_bps")]
        pts = s["samples"]
        got = tl.integrate(pts)
        want = totals.get(tier, 0.0) - totals0.get(tier, 0.0)
        # The samples' rounding: each rate rounds to 0.1 B/s over its
        # interval, each stamp to 1 µs.
        bound = 1.0 + sum(0.05 * (b[0] - a[0]) + 1e-6 * b[1]
                          for a, b in zip(pts, pts[1:]))
        bound += shift * max((v for _t, v in pts), default=0.0)
        if abs(got - want) > bound:
            fail(f"phase 17a: integrate({name}) {got:,.1f} B vs the "
                 f"counter's {want:,.1f} B (bound {bound:.1f} B)")
        ints[tier] = (round(got, 1), want, round(bound, 1))
    if "cdn" not in ints or "peer" not in ints:
        fail(f"phase 17a: fetch series {sorted(ints)}")
    # The engine decides inside the detector's firing: the first hedge's
    # stamp is the first firing's.
    fired = [e for e in doc["anomalies"] if e.get("session") == sess.id]
    fetch = res.stats["fetch"]
    print(f"phase 17a self-healing pull ({card_label()}): {kind} on "
          f"{sess.id}, first hedge {hedge['outcome']} {hedge['t'] - t0:.2f} "
          f"s into the pull; {len(fired)} firings on the session ("
          f"{sorted({e['kind'] for e in fired})}); decisions "
          f"{telemetry.remediate.payload()['counts']}; "
          f"{landing_summary(res.stats)}"
          f"; bytes {fetch['bytes']}, resilience {fetch['resilience']}; "
          f"files pull: {hedges['files'][0]}, hedge "
          f"{hedges['files'][1]['outcome']} "
          f"{hedges['files'][1]['t'] - t1:.2f} s into it, {t2 - t1:.2f} s "
          f"in all, bytes {fetch_f['bytes']}, resilience {resil}; seeder "
          f"served {served['chunks_served']} chunks; integrate vs counter "
          f"delta [got, want, bound] by tier {ints} (the stamps' wall "
          f"offset moved {shift * 1e6:.1f} µs); digest and files equal to "
          f"phase 4's")
    del res
    shutil.rmtree(work / "h17a")
    shutil.rmtree(work / "h17f")
    return {"heal_pull": launches}


def heal_collective(work: Path, url: str, cfg_a, ckpt: Path, pushed,
                    digest: str, dev) -> dict:
    """17b: a two-host collective round of revision A whose partner (host
    0, a bare ``DcnServer``) holds half of the units it owns and answers
    the rest NOT_FOUND for ever. The puller's barrier wait passes the
    window: the detector blames host 0 (``collective_straggler``), the
    engine's strike decision, at patience 1, aborts the exchange
    (``aborted == "remediation"``), the rest comes down the ladder, and
    the tree lands on the card with phase 4's digest. Kernel #3 (and #1)
    verified exactly the held units' chunks, before the abort. This is
    the process's only collective: the posted cells and the engine's
    ``collective`` target are process-wide."""
    from zest_tpu_torch import telemetry
    from zest_tpu_torch.cas.xorb import XorbReader
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.direct import (
        unit_layer_priorities,
        unit_priority_sort_key,
    )
    from zest_tpu_torch.models.safetensors_io import SafetensorsFile
    from zest_tpu_torch.transfer import coop
    from zest_tpu_torch.transfer.dcn import DcnServer
    from zest_tpu_torch.transfer.pull import pull_model

    partner = Config(hf_home=work / "h17p" / "hf",
                     cache_dir=work / "h17p" / "zest", endpoint=url,
                     dcn_port=0)
    cfg = Config(hf_home=work / "h17b" / "hf",
                 cache_dir=work / "h17b" / "zest", endpoint=url, dcn_port=0)
    recs = gpt2_recs(cfg, pushed.revision)
    with SafetensorsFile(ckpt / "model.safetensors") as sf:
        header = sf.header
    if len(recs) != 1:
        fail(f"phase 17b: {len(recs)} xet files")
    # The units in the order the exchange asks for them (layer order, as
    # the pull's header probe ranks them): the partner holds the first
    # half, so it delivers them all before it stalls.
    owned = sorted(coop.CoopPlan.build(recs, 2).for_host(0),
                   key=unit_priority_sort_key(unit_layer_priorities(
                       [(recs[0], header)])))
    held = owned[:len(owned) // 2]
    if not held:
        fail(f"phase 17b: host 0 owns {len(owned)} units")
    want = [0, 0]  # BG4 chunks, other chunks of the held units
    for hh, fi in held:
        blob = cfg_a.xorb_cache_path(hh).read_bytes()
        if (fi.range.start, fi.range.end) != (0, len(XorbReader(blob))):
            fail(f"phase 17b: unit {hh[:12]} {fi.range} is not its xorb")
        dst = partner.xorb_cache_path(hh)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes(blob)
        bg4, rest = bg4_chunks_of(blob)
        want[0] += bg4
        want[1] += rest
    server = DcnServer(partner)
    port = server.start()
    reset_counters()
    t0 = time.time()
    try:
        res = pull_model(cfg, REPO, revision=pushed.revision, device=dev,
                         coop=True, coop_hosts=2, coop_index=1,
                         coop_addrs={0: ("127.0.0.1", port)})
    finally:
        server.shutdown()
    launches = read_counters()
    c = res.stats["coop"]
    cx = c.get("collective") or {}
    if cx.get("aborted") != "remediation" or cx.get("dead_host") != 0:
        fail(f"phase 17b: the collective {cx}")
    ex = c["exchange"]
    if ex["units"] != len(held) or c["fallbacks"] != len(owned) - len(held):
        fail(f"phase 17b: exchanged {ex['units']} of {len(held)} held "
             f"units, {c['fallbacks']} fallbacks of {len(owned) - len(held)}")
    check_files("phase 17b", res, ckpt)
    check_tree("phase 17b", res, digest, dev)
    fu, b3 = launches["bg4_fused_verify"], launches["blake3_chunks"]
    if not fu[0] or fu[1] != want[0] or b3[1] != want[1]:
        fail(f"phase 17b: kernel #3 {fu}, #1 {b3} [launches, rows]; the "
             f"held units have {want[0]} BG4 and {want[1]} other chunks")
    strays = [e for e in telemetry.timeline.payload()["anomalies"]
              if e["kind"] == "collective_straggler"]
    if not strays or strays[0].get("partner") != 0:
        fail(f"phase 17b: straggler anomalies {strays}")
    strike = wait_decision(lambda e: e["action"] == "strike", "phase 17b")
    if (strike["outcome"], strike["detail"].get("cmd"),
            strike["detail"].get("partner")) != ("success", "abort", 0):
        fail(f"phase 17b: the strike decision {strike}")
    print(f"phase 17b straggler ({card_label()}): host 0 held "
          f"{len(held)} of its {len(owned)} units; collective_straggler "
          f"partner 0 {strays[0]['t'] - t0:.2f} s into the pull "
          f"(barrier_wait_s {strays[0].get('barrier_wait_s')}), strike "
          f"{strike['detail']} {strike['outcome']} "
          f"{strike['t'] - strays[0]['t']:.3f} s after it, aborted "
          f"{cx['aborted']} at elapsed {cx.get('elapsed_s')} s (barrier "
          f"{cx.get('barrier_wait_s')} s); exchanged {ex['units']} units, "
          f"{c['fallbacks']} down the ladder; {landing_summary(res.stats)};"
          f" kernel #3 {fu}, #1 {b3} [launches, rows]; digest and files "
          f"equal to phase 4's")
    del res
    shutil.rmtree(work / "h17p")
    shutil.rmtree(work / "h17b")
    return {"heal_collective": launches}


def heal_tune(work: Path, url: str, cfg_b, ckpt: Path, pushed,
              digest: str, dev):
    """17c, the ring tuner: two streaming landings of revision A from node
    B's cache onto the card through ``loader.stage_cached_to_hbm`` (the
    pull's landing, here with no file sink: a pull writing its files
    detaches each slot from the ring as it decodes, so its ring never
    waits on a copy), the ring ``HEAL_RING`` and 2 slots. The first
    stalls; the engine answers with a ``tune`` up decision (×2); the
    second lands with the override, inside the rails (≤ 8 × base). Both
    trees have phase 4's digest. Returns the second tree (17d swaps over
    it) and the path's launches."""
    from zest_tpu_torch import telemetry
    from zest_tpu_torch.cas.hub import HubClient
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.loader import params_digest, stage_cached_to_hbm
    from zest_tpu_torch.models.safetensors_io import SafetensorsFile
    from zest_tpu_torch.transfer.bridge import XetBridge

    cfg = Config(hf_home=work / "h17r" / "hf", cache_dir=cfg_b.cache_dir,
                 endpoint=url, land_ring_bytes=HEAL_RING, land_ring_slots=2)
    with SafetensorsFile(ckpt / "model.safetensors") as sf:
        header = sf.header
    bridge = XetBridge(cfg)
    runs, params = [], None
    reset_counters()
    try:
        bridge.authenticate(REPO, pushed.revision)
        (rec,) = [bridge.get_reconstruction(e.xet_hash)
                  for e in HubClient(cfg).list_files(REPO, pushed.revision)
                  if e.is_xet]
        for i in range(2):
            params = None  # the first tree goes before the second lands
            params, hbm = stage_cached_to_hbm(bridge, [(rec, header)], dev,
                                              stream=True)
            if params_digest(params) != digest:
                fail(f"phase 17c: landing {i}'s digest")
            ring = hbm["ring"]
            runs.append((ring["budget_bytes"], ring["stalls"],
                         hbm["elapsed_s"]))
            if i == 0:
                tune = wait_decision(
                    lambda e: e["action"] == "tune"
                    and e["detail"].get("from") == HEAL_RING, "phase 17c")
                if (tune["outcome"], tune["detail"].get("dir"),
                        tune["detail"].get("to")) != ("success", "up",
                                                      2 * HEAL_RING):
                    fail(f"phase 17c: the tune decision {tune}")
    finally:
        bridge.close()
    knob = telemetry.remediate.payload()["knobs"]["land_ring_bytes"]
    if runs[0][1] < 1 or runs[1][0] != 2 * HEAL_RING \
            or knob["max"] != 8 * HEAL_RING or runs[1][0] > knob["max"]:
        fail(f"phase 17c: landings [budget, stalls, s] {runs}, knob "
             f"{knob}")
    print(f"phase 17c ring tuner: landing 0 ring {runs[0][0]:,} B, "
          f"{runs[0][1]} stalls in {runs[0][2]} s; tune {tune['detail']} "
          f"{tune['outcome']}; landing 1 ring {runs[1][0]:,} B (the "
          f"override), {runs[1][1]} stalls in {runs[1][2]} s; rails "
          f"[{knob['min']:,}, {knob['max']:,}]; digests equal")
    return params, {"heal_tune": read_counters()}


def heal_pool(work: Path, seed: int, dev) -> dict:
    """17c, the pool rules: an ``HbmPool`` on the card whose watermark
    (1.5 trees) holds one of two Llama-family trees (``HEAL_POOL_LAYERS``
    layers at Llama-3.2-1B's width, random bf16 from ``seed + 17``; the
    second is the first's file under another snapshot), requested X, Y,
    X. The first cold land's decode waits at its gates while the land
    sleeps after each flush: the gate stall grows with a land in flight
    and the engine's hedge rushes the flushes (``pool_land``), the rush
    seen set on the pool; each request evicts the other tree and the
    eviction growth gives a ``shed`` decision on ``pool_shed``. The
    allocation is one tree's after each request (the evicted tree's
    memory went back), and closing the pool gives back at least the
    resident tree."""
    import torch

    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models import hbm_pool
    from zest_tpu_torch.models.safetensors_io import write_safetensors

    cfg_l = dict(LLAMA_CONFIG, num_hidden_layers=HEAL_POOL_LAYERS)
    tensors = llama_checkpoint(seed + 17, cfg_l, dev)
    tree = sum(t.numel() * t.element_size() for t in tensors.values())
    snaps = [work / "h17x", work / "h17y"]
    for s in snaps:
        s.mkdir()
        (s / "config.json").write_text(json.dumps(cfg_l, indent=2))
    write_safetensors(snaps[0] / "model.safetensors", tensors)
    os.link(snaps[0] / "model.safetensors", snaps[1] / "model.safetensors")
    del tensors
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    pool = hbm_pool.HbmPool(Config(
        hf_home=work / "h17l" / "hf", cache_dir=work / "h17l" / "zest",
        hbm_pool_bytes=int(1.5 * tree)), dev)
    pool.land_delay_s = HEAL_LAND_DELAY_S
    rush, stop = [], threading.Event()

    def watch_rush():
        while not stop.is_set():
            if pool._rush.is_set() and not rush:
                rush.append(time.time())
            time.sleep(0.002)

    watcher = threading.Thread(target=watch_rush, name="phase-17c-rush")
    watcher.start()
    rows = []
    reset_counters()
    try:
        for s in (snaps[0], snaps[1], snaps[0]):
            t0 = time.monotonic()
            _ids, info = pool.generate_for(s, s.name, [[1, 2, 3, 4]], 2,
                                           stop_at_eos=False)
            # The land thread keeps its pin through its last sleep: the
            # tree is evictable once it is published resident.
            deadline = time.monotonic() + 30
            while pool._landing_count():
                if time.monotonic() > deadline:
                    fail("phase 17c pool: a land never ended")
                time.sleep(0.01)
            torch.cuda.synchronize(dev)
            held = torch.cuda.memory_allocated(dev) - base
            rows.append((s.name, info["temp"], info["gate_stall_s"],
                         round(time.monotonic() - t0, 3), held))
            if held > tree + (64 << 20):
                fail(f"phase 17c pool: {held:,} B held after {s.name}, "
                     f"above one tree's {tree:,} B")
        hedge = wait_decision(
            lambda e: e["action"] == "hedge"
            and e["detail"].get("cmd") == "rush", "phase 17c pool")
        shed = wait_decision(
            lambda e: e["action"] == "shed"
            and e["detail"].get("cmd") == "shed_coldest", "phase 17c pool")
        summary = pool.summary()
    finally:
        stop.set()
        watcher.join()
        pool.close()
    if hedge["outcome"] != "success" or not rush:
        fail(f"phase 17c pool: the rush decision {hedge}, rush seen {rush}")
    if shed["outcome"] != "success" or summary["evictions"] < 2:
        fail(f"phase 17c pool: the shed decision {shed}, pool {summary}")
    torch.cuda.synchronize(dev)
    left = torch.cuda.memory_allocated(dev) - base
    # Phase 9a's rule: closing gives back at least the resident tree (the
    # decode's first matmul may leave cuBLAS's workspace behind).
    if left > rows[-1][4] - tree:
        fail(f"phase 17c pool: {left:,} B still allocated after close, "
             f"{rows[-1][4]:,} B before it")
    print(f"phase 17c pool rules: tree {tree:,} B, watermark "
          f"{int(1.5 * tree):,} B; requests [snapshot, temp, gate_stall_s, "
          f"s, allocated above the start] {rows}; hedge {hedge['detail']} "
          f"{hedge['outcome']}, rush seen {rush[0] - hedge['t']:+.3f} s "
          f"from it; shed {shed['detail']} {shed['outcome']}; evictions "
          f"{summary['evictions']}; {left:,} B above the start after "
          f"close")
    for s in snaps:
        shutil.rmtree(s)
    return {"heal_pool": read_counters()}


def heal_surfaces(work: Path, url: str, publisher, cfg_a, cfg_b,
                  ckpt: Path, pushed, tree: dict, seed: int, dev) -> dict:
    """17d: the surfaces on node A's publisher (this process's daemon).
    ``GET /v1/timeline`` paged by cursor with no sample repeated;
    ``?scope=pod`` over a second daemon naming A's as pod peer 1 (its
    clock offset applied, or ``applied_offset_s: null``); ``GET`` and
    ``POST /v1/remediations`` with the dry-run toggle; ``GET /`` the
    dashboard; ``zest top`` (one frame) and ``zest heal`` exit 0 against
    A's daemon. Revision D (A with ``ln_f.weight`` drawn again from
    ``seed``) is pushed with ``notify_url`` (kernel #1 re-verifies its
    minted chunks): the daemon posts ``push.new_xorb_bytes`` and
    ``push.dedup_ratio``, and a ``watch_and_swap`` onto ``cuda:0`` over
    17c's second tree (``tree``, handed over), on a node over B's cache,
    posts ``push.propagation_s``; ``zest diff --push-preview`` prints D's
    preview first."""
    import contextlib
    import io
    import urllib.error
    import urllib.request

    from zest_tpu_torch import cli, telemetry
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.transfer.push import push_checkpoint, watch_and_swap

    def get(base_url, path):
        with urllib.request.urlopen(base_url + path, timeout=10) as r:
            body = r.read()
            return r.headers.get("Content-Type", ""), body

    def get_json(base_url, path):
        return json.loads(get(base_url, path)[1].decode())

    def post(path, body):
        req = urllib.request.Request(url + path, data=body, method="POST",
                                     headers={"Content-Type":
                                              "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, json.loads(r.read().decode())
        except urllib.error.HTTPError as exc:
            return exc.code, None

    # The cursor-paged timeline: three pages over the live sampler.
    doc = get_json(url, "/v1/timeline")
    seen = {(n, t) for n, s in doc["series"].items()
            for t, _v in s["samples"]}
    cursor, pages = doc["cursor"], []
    for _ in range(3):
        wait_ticks(1)
        page = get_json(url, f"/v1/timeline?since={cursor}")
        new = [(n, t) for n, s in page["series"].items()
               for t, _v in s["samples"]]
        if page["cursor"] <= cursor or not new or seen & set(new) \
                or len(set(new)) != len(new):
            fail(f"phase 17d: page past {cursor}: cursor {page['cursor']}, "
                 f"{len(new)} samples, {len(seen & set(new))} repeated")
        seen |= set(new)
        pages.append(len(new))
        cursor = page["cursor"]
    # Pod scope over two daemons.
    port_a = int(url.rsplit(":", 1)[1])
    cfg_p = Config(hf_home=work / "h17d" / "hf",  # nothing is written
                   cache_dir=work / "h17d" / "zest", coop_index=0,
                   pod_peers={1: ("127.0.0.1", port_a)})
    with PublisherServer(cfg_p, device=dev) as coord:
        pod = get_json(coord.url, "/v1/timeline?scope=pod")
    norm = pod.get("clock_normalization", {})
    if pod.get("hosts") != ["0", "1"] or set(norm) != {"0", "1"} \
            or pod.get("scrape_errors") \
            or not any(n.startswith("h1.") for n in pod["series"]):
        fail(f"phase 17d: pod timeline hosts {pod.get('hosts')}, "
             f"normalization {norm}, errors {pod.get('scrape_errors')}")
    # The remediations surface and the dry-run toggle.
    rem = get_json(url, "/v1/remediations?limit=5")
    flips = [post("/v1/remediations", b'{"dry_run": true}'),
             (200, {"dry_run": get_json(url, "/v1/remediations")
                    ["dry_run"]}),
             post("/v1/remediations", b'{"dry_run": false}'),
             (post("/v1/remediations", b"not json")[0], None)]
    if not rem["enabled"] or rem["dry_run"] or not rem["counts"] \
            or flips != [(200, {"dry_run": True}), (200, {"dry_run": True}),
                         (200, {"dry_run": False}), (400, None)]:
        fail(f"phase 17d: /v1/remediations {rem.get('counts')}, the "
             f"toggle {flips}")
    ctype, page = get(url, "/")
    if not ctype.startswith("text/html") or b"zest-tpu-torch" not in page:
        fail(f"phase 17d: GET / answered {ctype}, {len(page)} B")
    # The CLI against A's daemon.
    env_keep = {k: os.environ.get(k) for k in ("ZEST_HTTP_PORT", "HF_HOME",
                                               "ZEST_CACHE_DIR")}
    os.environ.update(ZEST_HTTP_PORT=str(port_a),
                      HF_HOME=str(cfg_a.hf_home),
                      ZEST_CACHE_DIR=str(cfg_a.cache_dir))
    outs = {}
    try:
        for argv in (["top", "--count", "1"], ["heal"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv)
            outs[argv[0]] = buf.getvalue()
            if rc != 0:
                fail(f"phase 17d: zest {' '.join(argv)} exited {rc}")
        if "zest top" not in outs["top"] \
                or "self-healing: live" not in outs["heal"]:
            fail(f"phase 17d: zest top / heal printed {outs}")
        # Revision D, its preview, its push and the watcher's swap.
        tensors_d = revision_b(load_checkpoint(ckpt, "cpu"), seed,
                               names=("ln_f.weight",))
        ckpt_d = work / "checkpoint-d"
        ckpt_d.mkdir()
        (ckpt_d / "config.json").write_text(json.dumps(GPT2_CONFIG,
                                                       indent=2))
        write_safetensors(ckpt_d / "model.safetensors", tensors_d)
        del tensors_d
        digest_d = params_digest(load_checkpoint(ckpt_d, "cpu"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["diff", f"{REPO}@{pushed.revision}",
                           "--push-preview", str(ckpt_d)])
        preview = buf.getvalue()
        if rc != 0 or "push preview" not in preview \
                or "dedup ratio" not in preview:
            fail(f"phase 17d: zest diff --push-preview exited {rc}: "
                 f"{preview}")
    finally:
        for k, v in env_keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    cfg_w = Config(hf_home=work / "h17w" / "hf", cache_dir=cfg_b.cache_dir,
                   endpoint=url)
    seen_swap, errors = [], []

    def watch():
        try:
            watch_and_swap(cfg_w, REPO, publisher_url=url, device=dev,
                           base_params=tree,
                           base_revision=pushed.revision, max_events=1,
                           timeout_s=120,
                           on_swap=lambda rec, res: seen_swap.append(
                               (rec, res)),
                           log=lambda *a, **k: None)
        except Exception as exc:  # noqa: BLE001 - re-raised below
            errors.append(exc)

    watcher = threading.Thread(target=watch, name="phase-17d-watch")
    watcher.start()
    try:
        deadline = time.monotonic() + 60
        while publisher.hub.watchers() < 1:
            if time.monotonic() > deadline or not watcher.is_alive():
                fail("phase 17d: the watcher never subscribed")
            time.sleep(0.01)
        reset_counters()
        pushed_d = push_checkpoint(cfg_a, REPO, ckpt_d,
                                   base_revision=pushed.revision,
                                   notify=True, notify_url=url, device=dev)
        push_launches = read_counters()
    finally:
        watcher.join(timeout=300)
    if errors:
        raise errors[0]
    if len(seen_swap) != 1:
        fail(f"phase 17d: the watcher swapped {len(seen_swap)} revisions")
    b1 = push_launches["blake3_chunks"]
    if b1[0] < 1 or b1[1] != pushed_d.minted_chunks:
        fail(f"phase 17d: the push's kernel #1 {b1} [launches, rows], "
             f"{pushed_d.minted_chunks} minted chunks")
    rec, res = seen_swap[0]
    check_tree("phase 17d swap", res, digest_d, dev)
    wait_ticks(2)
    push_series = telemetry.timeline.payload(prefix="push.")["series"]
    last = {n: s["samples"][-1][1] for n, s in push_series.items()}
    if last.get("push.new_xorb_bytes") != float(pushed_d.new_xorb_bytes) \
            or abs(last.get("push.dedup_ratio", -1)
                   - round(pushed_d.dedup_ratio, 4)) > 1e-12 \
            or abs(last.get("push.propagation_s", -1)
                   - rec["propagation_s"]) > 1e-3:
        fail(f"phase 17d: push series {last}; push "
             f"{pushed_d.new_xorb_bytes} B, dedup "
             f"{pushed_d.dedup_ratio}, record {rec}")
    print(f"phase 17d surfaces: /v1/timeline pages of {pages} new samples "
          f"past each cursor, none repeated; ?scope=pod hosts "
          f"{pod['hosts']}, normalization {norm}; /v1/remediations counts "
          f"{rem['counts']}, dry-run toggled on and off, bad body 400; "
          f"GET / {len(page):,} B of {ctype}; zest top {len(outs['top'].splitlines())} "
          f"lines, zest heal {len(outs['heal'].splitlines())} lines; "
          f"preview {' '.join(preview.split())}; push D "
          f"{pushed_d.new_xorbs} xorbs, {pushed_d.minted_chunks} chunks, "
          f"kernel #1 {b1}; swap time_to_swap_s "
          f"{res.stats.get('time_to_swap_s')}, propagation_s "
          f"{rec['propagation_s']}; push series {last}")
    res.params = None
    del res
    shutil.rmtree(ckpt_d)
    shutil.rmtree(work / "h17w")
    return {"heal_push": push_launches}


def heal_phase(work: Path, url: str, publisher, cfg_a, cfg_b, ckpt: Path,
               pushed, digest: str, seed: int, dev) -> dict:
    """Phase 17: the self-healing control plane on the card (see 17a–17d
    above), under ``HEAL_ENV``: the timeline and the engine are rebuilt
    with those knobs for this phase and rebuilt from the environment
    after it. Returns each path's ``[launches, rows]`` by kernel."""
    import torch

    from zest_tpu_torch import telemetry

    tl, rm = telemetry.timeline, telemetry.remediate
    keep = {k: os.environ.get(k) for k in HEAL_ENV}
    os.environ.update(HEAL_ENV)
    tl.reset()
    rm.reset()
    wall0 = time.monotonic()
    try:
        totals0 = fetch_totals()
        if not (tl.ensure_started() and rm.ensure_started()):
            fail("phase 17: the timeline or the engine is off")
        paths = heal_pull(work, url, cfg_b, ckpt, pushed, digest, totals0,
                          dev)
        t = time.monotonic()
        paths.update(heal_collective(work, url, cfg_a, ckpt, pushed, digest,
                                     dev))
        t_b = time.monotonic() - t
        tree, tune_paths = heal_tune(work, url, cfg_b, ckpt, pushed,
                                     digest, dev)
        paths.update(tune_paths)
        paths.update(heal_pool(work, seed, dev))
        torch.cuda.empty_cache()
        paths.update(heal_surfaces(work, url, publisher, cfg_a, cfg_b, ckpt,
                                   pushed, tree, seed + 17, dev))
        del tree
        counts = rm.payload(limit=256)["counts"]
        anomalies = sorted({e["kind"] for e in tl.payload()["anomalies"]})
    finally:
        for k, v in keep.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        tl.reset()
        rm.reset()
    for path, counts_k in paths.items():
        if path not in ("heal_collective", "heal_push") \
                and any(n for n, _rows in counts_k.values()):
            fail(f"phase 17: kernel launches on {path}: {counts_k}")
    print(f"phase 17 wall {time.monotonic() - wall0:.2f} s (17b "
          f"{t_b:.2f} s); anomaly kinds {anomalies}; decisions by action "
          f"and outcome {counts}; kernel [launches, rows] by path {paths}")
    return {path: {k: n for k, (n, _rows) in c.items()}
            for path, c in paths.items()}


# ── Phase 18: GPT-2's sharded step ──

GPT2_TRAIN_MESH = {"data": 2, "model": 2}
GPT2_PARAMS = 124_439_808
# 18 against 12a: the same start, batch and recipe, the sums in other
# orders: the losses within 1e-5 relative; after step 2 the first moments
# and parameters by 13b's rules (SHARD_MU_TOL, SHARD_PARAM_BOUND and
# SHARD_PARAM_SHARE), over every leaf.
GPT2_LOSS_RTOL = 1e-5


def sharded_gpt2_phase(work: Path, url: str, sha_a: str, ref: dict,
                       prompts: list, steps: int, dev) -> dict:
    """Phase 18: GPT-2's sharded step at its published width. A fresh
    node pulls phase 3's revision A over ``GPT2_TRAIN_MESH`` on four slots
    of ``dev`` with the pod pre-pass (kernel #3's and #1's launches and
    rows those of the plan's whole-xorb units); ``params_from_hf`` of the
    landing (no flag) gives the one sharded tree under
    ``gpt2.param_specs``, which takes two AdamW steps with 12a's recipe on
    12a's batch cut over ``data``: the losses and, after step 2, the
    gathered parameters and first moments 12a's (``ref``), the replicas
    bit-equal after each step. Then greedy decode at batch 1 and 4
    through the ``TPParams`` tree built from the trained tree (the q|k|v
    columns regrouped into whole heads a slot): its tokens those of the
    unsharded decode of the same trained params. Returns the kernels'
    launches in the pull."""
    import functools

    import torch

    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models import gpt2, training
    from zest_tpu_torch.models import tensor_parallel as tp
    from zest_tpu_torch.parallel import DistributionPlan
    from zest_tpu_torch.parallel.mesh import model_mesh
    from zest_tpu_torch.transfer.pull import pull_model

    wall0 = time.monotonic()
    cfg = gpt2.GPT2Config.from_hf(GPT2_CONFIG)
    mesh = model_mesh(GPT2_TRAIN_MESH, [dev] * 4)
    cfg_g = Config(hf_home=work / "g18" / "hf",
                   cache_dir=work / "g18" / "zest", endpoint=url,
                   hbm_staging_bytes=POD_BUDGET)
    reset_counters()  # counts from here are the mesh landing's
    t0 = time.monotonic()
    res = pull_model(cfg_g, REPO, revision=sha_a, device=dev, mesh=mesh,
                     pod=True)
    pull_s = time.monotonic() - t0
    launches = read_counters()
    st, pod = res.stats, res.stats.get("pod")
    plan = DistributionPlan.build(gpt2_recs(cfg_g, sha_a), mesh.size)
    want, prefixes = plan_launches(plan, cfg_g)
    if not st["hbm"]["sharded"] or not pod or pod.get("skipped") \
            or not 0 < pod["filled"] == pod["units"] or prefixes \
            or launches != want or want["bg4_fused_verify"][0] < 1:
        fail(f"phase 18: sharded {st['hbm']['sharded']}, pod {pod}; kernel "
             f"launches (rows) {launches}, the plan's whole-xorb units "
             f"predict {want} ({prefixes} prefixes)")
    t0 = time.monotonic()
    tree = gpt2.params_from_hf(res.params, cfg)
    torch.cuda.synchronize(dev)
    build_s = time.monotonic() - t0
    res.params = None
    n_params = sum(int(np.prod(t.shape)) for t in training.tree_leaves(tree))
    specs = {"/".join(p): tuple(t.spec) for p, t in training.tree_paths(tree)}
    if n_params != GPT2_PARAMS or specs["blocks/attn/qkv_w"] != (
            None, None, "model") or specs["wte"] != ():
        fail(f"phase 18: the sharded tree holds {n_params:,} params, specs "
             f"{specs}")
    batch = ft_batch(cfg.vocab_size, ref["batch_seed"], dev)
    tx = training.adamw(**FT_ADAMW)
    step = training.make_train_step(tx, functools.partial(gpt2.loss_fn,
                                                          cfg=cfg))
    state = training.create_state(tree, tx)
    del tree
    losses, times = [], []
    for k in range(2):
        ms, (state, loss) = step_ms(dev, lambda s=state: step(s, batch))
        times.append(ms)
        losses.append(float(loss))
        if not (_replicas_equal(state.params)
                and _replicas_equal(state.opt_state.mu)
                and _replicas_equal(state.opt_state.nu)):
            fail(f"phase 18: the replicas differ after step {k + 1}")
    for got, want_loss in zip(losses, ref["losses"]):
        if not abs(got - want_loss) <= GPT2_LOSS_RTOL * abs(want_loss):
            fail(f"phase 18: losses {losses} off 12a's {ref['losses']} by "
                 f"more than {GPT2_LOSS_RTOL:.0e} relative")
    errs, worst_share = {}, 0.0
    for name, tree in (("params", state.params), ("mu", state.opt_state.mu)):
        want_tree = dict(training.tree_paths(ref[name]))
        for path, t in training.tree_paths(tree):
            w = want_tree[path]
            d = (t.full().cpu() - w).abs()
            key = f"{name} {'/'.join(path)}"
            errs[key] = float(d.max())
            if name == "mu":
                bound = SHARD_MU_TOL * float(w.abs().max())
                if not errs[key] <= bound:
                    fail(f"phase 18: {key} after step 2 off 12a's by "
                         f"{errs[key]:.3e} > {bound:.3e}")
                continue
            share = float((d > 1e-6).float().mean())
            worst_share = max(worst_share, share)
            if not (errs[key] <= SHARD_PARAM_BOUND
                    and share <= SHARD_PARAM_SHARE):
                fail(f"phase 18: {key} after step 2 off 12a's by "
                     f"{errs[key]:.3e} (bound {SHARD_PARAM_BOUND:.0e}), "
                     f"{share:.2e} of it beyond 1e-6")
    # Decode: the TPParams tree of the trained tree against the unsharded
    # decode of the same trained params.
    trained = state.params
    del state
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    dec = tp.decode_params(trained, cfg)
    dec_s = time.monotonic() - t0
    plain = training.tree_map(lambda t: t.full(), trained)
    rates, plain_rates = {}, {}
    for b in (1, 4):
        rows = prompts[:b]
        gpt2.generate_cached(dec, cfg, rows, 2)  # warm-up
        torch.cuda.synchronize(dev)
        t0 = time.monotonic()
        got = gpt2.generate_cached(dec, cfg, rows, steps).cpu().numpy()
        rates[b] = b * steps / (time.monotonic() - t0)
        t0 = time.monotonic()
        want_tokens = gpt2.generate_cached(plain, cfg, rows,
                                           steps).cpu().numpy()
        plain_rates[b] = b * steps / (time.monotonic() - t0)
        if not np.array_equal(got, want_tokens):
            fail(f"phase 18: batch {b}: tensor-parallel tokens differ from "
                 "the unsharded decode of the trained params")
    gather = dec.gather_bytes
    del dec, plain, trained
    shutil.rmtree(work / "g18")
    torch.cuda.empty_cache()
    top = sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    print(f"phase 18 sharded GPT-2 ({card_label()}): {REPO} revision A "
          f"({n_params:,} float32 params) over {GPT2_TRAIN_MESH} on "
          f"[{dev}] * 4: pulled in {pull_s:.2f} s, {landing_summary(st)}; "
          f"pod {pod}, kernel launches (rows) {launches} = the plan's "
          f"whole-xorb units; params_from_hf (the sharded tree) in "
          f"{build_s:.2f} s; AdamW {FT_ADAMW} on 12a's batch {FT_BATCH} cut "
          f"over data: losses {[round(x, 6) for x in losses]} (12a "
          f"{[round(x, 6) for x in ref['losses']]}), step ms "
          f"{[round(t, 2) for t in times]}; after step 2 vs 12a: largest "
          f"|d| {[(k, f'{v:.2e}') for k, v in top]}, worst share beyond "
          f"1e-6 {worst_share:.2e}; replicas bit-equal; TPParams from the "
          f"trained tree in {dec_s:.2f} s (gathered {gather:,} B: the fused "
          f"q|k|v, regrouped), greedy tok/s b1 {rates[1]:.1f}, b4 "
          f"{rates[4]:.1f} (unsharded {plain_rates[1]:.1f}, "
          f"{plain_rates[4]:.1f}), tokens = the unsharded decode's at "
          f"batch 1 and 4; phase wall {time.monotonic() - wall0:.2f} s")
    return {name: n for name, (n, _rows) in launches.items()}


# ── Phase 19: zest bench and the scale benches ──

# The JAX package's synthetic suite, by name (zest_tpu/bench_suite.py).
REFERENCE_BENCHES = (
    "bencode_encode", "bencode_decode", "blake3_64kb", "sha1_info_hash",
    "bt_wire_frame", "gearhash_cdc_4mb", "xet_frame_64kb",
    "dcn_fetch_pipelined", "blake3_64kb_device", "ici_all_gather",
    "ring_attention", "pipeline_gpipe")
# 19a: bench_blake3_device's batch (256 chunks of 64 KiB) and launches.
BENCH_BLAKE3 = {"batch": 256, "iters": 8}
# 19b: the smallest checkpoint at full Llama-8B width with two layers.
BENCH_GB = 0.961
BENCH_SCALE = 1
# 19c: bench_coop_pull's default 64 MB over four hosts, each host's DCN
# server shaped to a rate whose burst (a quarter second of it) is below
# what a server sends in one exchange, so the bucket paces it.
BENCH_COOP = {"gb": 0.064, "n_hosts": 4, "dcn_bps": 50_000_000,
              "dcn_rtt_s": 0.005}
COOP_LEGS = ("coop", "xp2p", "xcol")  # the three rounds that exchange
# 19d: one fleet size, the JAX package's smallest.
BENCH_FLEET = {"fleet_sizes": (256,), "pod_size": 64}


def bench_cli_phase(dev) -> dict:
    """19a: ``python -m zest_tpu_torch bench --json`` in a child on the
    card: every bench of the JAX package's suite, the device ones
    included. Then ``bench_blake3_device`` in-process: its last batch's
    kernel-#1 digests equal the plain version's. Returns the in-process
    run's launches by kernel."""
    import torch

    from zest_tpu_torch import bench_suite
    from zest_tpu_torch.ops import blake3_cuda
    from zest_tpu_torch.ops import blake3 as plain

    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "zest_tpu_torch", "bench", "--json"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=300)
    if proc.returncode != 0:
        fail(f"phase 19a: zest bench exited {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    rows = json.loads(proc.stdout)
    names = [r["name"] for r in rows]
    missing = [n for n in REFERENCE_BENCHES if n not in names]
    if missing:
        fail(f"phase 19a: zest bench lacks {missing}; it ran {names}")
    cli_s = time.monotonic() - t0
    print(f"phase 19a zest bench ({card_label()}) in {cli_s:.2f} s: "
          + ", ".join(f"{r['name']} {r['mb_per_s']} MB/s" for r in rows))

    seen = {}
    real = blake3_cuda.CudaHasher.hash_device

    def hash_device(self, words, lengths):
        out = real(self, words, lengths)
        seen.update(hasher=self, words=words, lengths=lengths, out=out)
        return out

    reset_counters()
    blake3_cuda.CudaHasher.hash_device = hash_device
    try:
        res = bench_suite.bench_blake3_device(device=str(dev),
                                              **BENCH_BLAKE3)
    finally:
        blake3_cuda.CudaHasher.hash_device = real
    counts = read_counters()
    hasher, words = seen["hasher"], seen["words"]
    want = plain.hash_words(words, seen["lengths"], hasher.key_words,
                            hasher.base_flags)
    torch.cuda.synchronize()
    batch = BENCH_BLAKE3["batch"]
    if words.shape != (batch, 64 * 1024 // 4) or words.device != dev:
        fail(f"phase 19a: the bench hashed {tuple(words.shape)} on "
             f"{words.device}")
    if max_abs_err(seen["out"], want):
        fail("phase 19a: the bench's kernel-#1 digests differ from the "
             "plain version's")
    launches, batch_rows = counts["blake3_chunks"]
    if launches != 1 + 3 * res.iters or batch_rows != batch * launches:
        fail(f"phase 19a: kernel #1 launched {counts['blake3_chunks']}, "
             f"not 1 + 3 x {res.iters} batches of {batch}")
    print(f"phase 19a bench_blake3_device: {res.as_dict()}; its {batch} "
          f"digests equal the plain version's; kernel #1 [launches, rows] "
          f"{counts['blake3_chunks']}")
    return {k: n for k, (n, _rows) in counts.items()}


def bench_gb_phase(dev) -> dict:
    """19b: ``bench_gb_pull`` at full Llama-8B width (``BENCH_GB``, two
    layers, 1,396,744,192 tensor bytes), one timed run onto ``dev`` (the
    warm-up skipped by a spent budget). Gates, on the pull the bench
    times: every tensor on ``dev``, the landed bytes the fixture's tensor
    bytes, the direct landing. Returns the pull's launches by kernel."""
    from zest_tpu_torch import bench_scale
    from zest_tpu_torch.transfer import pull as pull_mod

    want_bytes = bench_scale.llama_tensor_bytes(BENCH_GB, BENCH_SCALE)
    want_tensors = 3 + 9 * bench_scale.llama_layers(BENCH_GB, BENCH_SCALE)
    landed = []
    real = pull_mod.pull_model

    def pull_model(*a, **k):
        res = real(*a, **k)
        params = res.params or {}
        landed.append({
            "tensors": len(params),
            "on_device": sum(t.device == dev for t in params.values()),
            "bytes": sum(t.nbytes for t in params.values()),
            "hbm_bytes": res.stats["hbm"]["bytes"],
            "direct": res.stats["hbm"]["direct"]})
        return res

    reset_counters()
    pull_mod.pull_model = pull_model
    try:
        r = bench_scale.bench_gb_pull(gb=BENCH_GB, runs=1,
                                      scale=BENCH_SCALE, budget_s=1.0,
                                      device=str(dev))
    finally:
        pull_mod.pull_model = real
    counts = read_counters()
    if len(landed) != 1:
        fail(f"phase 19b: {len(landed)} pulls ran, not one timed pull")
    got = landed[0]
    if (got["tensors"], got["on_device"]) != (want_tensors, want_tensors):
        fail(f"phase 19b: {got['on_device']} of {got['tensors']} tensors "
             f"on {dev}, {want_tensors} expected")
    if got["bytes"] != want_bytes or got["hbm_bytes"] != want_bytes:
        fail(f"phase 19b: landed {got['bytes']:,} B (hbm {got['hbm_bytes']:,}"
             f"), the fixture holds {want_bytes:,} tensor bytes")
    if not (got["direct"] and r["direct"]):
        fail(f"phase 19b: the landing was not direct: {r}")
    stages = {k: v["s"] for k, v in r["stages"].items()}
    print(f"phase 19b bench_gb_pull ({card_label()}): {r['checkpoint_gb']} "
          f"GB {r['geometry']}, {want_tensors} tensors on {dev}, "
          f"{want_bytes:,} B landed directly; time_to_hbm_s "
          f"{r['time_to_hbm_s']}, time_to_first_layer_s "
          f"{r.get('time_to_first_layer_s')}, {r['pull_gbps']} GB/s, hbm "
          f"{r['hbm_gbps']} GB/s; stage medians {stages}; fixture gen "
          f"{r['fixture_gen_s']} s, encode {r['fixture_encode_s']} s, "
          f"{r['xorbs']} xorbs, warm-up skipped {r['warmup_skipped']}; "
          f"kernel [launches, rows] {counts}")
    return {k: n for k, (n, _rows) in counts.items()}


def bench_coop_phase(dev) -> dict:
    """19c: ``bench_coop_pull`` (``BENCH_COOP``: 64 MB, four hosts, every
    DCN server shaped). Gates: 0 fallbacks in each round; kernel #3's
    launches the received units holding BG4 chunks, its rows their BG4
    chunks, kernel #1's rows their other chunks (each host receives every
    unit it does not own, in each of the three exchanging rounds); every
    shaped server's ``DcnServerStats.bytes_served`` equal to the bytes its
    peers received from it and to the bytes it charged its token bucket,
    and the span from its first charge to its last charge's return at
    least (charged - burst) / rate: the bucket starts at most full, so
    no more than burst + rate x span can pass it. Returns the launches by
    kernel."""
    from zest_tpu_torch import bench_hub, bench_scale
    from zest_tpu_torch.cas.compression import Scheme
    from zest_tpu_torch.cas.xorb import XorbReader
    from zest_tpu_torch.parallel.plan import collect_units
    from zest_tpu_torch.transfer import dcn

    repos, servers, by_port = [], [], {}

    class Repo(bench_hub.FixtureRepo):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            repos.append(self)

    class Server(dcn.DcnServer):
        def start(self):
            self.received = self.charged = 0
            self.waited, self.charges = 0.0, []
            self.opened = time.monotonic()
            bucket, lock = self._bucket, threading.Lock()
            if bucket is not None:
                real_acquire = bucket.acquire

                def acquire(n, give_up_at=None):
                    t0 = time.monotonic()
                    ok = real_acquire(n, give_up_at)
                    t1 = time.monotonic()
                    with lock:
                        self.charged += n
                        self.waited += t1 - t0
                        self.charges.append((t0, t1))
                    return ok

                bucket.acquire = acquire
            port = super().start()
            servers.append(self)
            by_port[port] = self
            return port

        def shutdown(self):
            self.closed = time.monotonic()
            super().shutdown()

    real_many = dcn.DcnPool.request_many

    def request_many(self, host, port, wants, *a, **k):
        replies = real_many(self, host, port, wants, *a, **k)
        owner = by_port.get(port)
        if owner is not None:
            owner.received += sum(len(r.data) for r in replies
                                  if isinstance(r, dcn.DcnResponse))
        return replies

    saved = bench_hub.FixtureRepo, dcn.DcnServer
    reset_counters()
    bench_hub.FixtureRepo, dcn.DcnServer = Repo, Server
    dcn.DcnPool.request_many = request_many
    try:
        r = bench_scale.bench_coop_pull(device=str(dev), **BENCH_COOP)
    finally:
        bench_hub.FixtureRepo, dcn.DcnServer = saved
        dcn.DcnPool.request_many = real_many
    counts = read_counters()
    if r.get("errors"):
        fail(f"phase 19c: {r['errors']}")
    n = BENCH_COOP["n_hosts"]
    blocks = {"coop": r["coop"], "xp2p": r["exchange"]["p2p"],
              "xcol": r["exchange"]["collective"]}
    for leg, b in blocks.items():
        if b["hosts_completed"] != n or b["fallbacks"]:
            fail(f"phase 19c {leg}: {b['hosts_completed']} hosts done, "
                 f"{b['fallbacks']} fallbacks")

    repo = repos[0]
    schemes = {h: XorbReader(x.full or x.blob).chunk_schemes
               for h, x in repo.xorbs.items()}
    units = [(hh, fi) for (hh, _s), fi in
             collect_units(list(repo.reconstructions.values()))]
    bg4_units = bg4 = rest = 0
    for hh, fi in units:
        sch = schemes[hh][fi.range.start:fi.range.end]
        k = int((sch == int(Scheme.BG4_LZ4)).sum())
        bg4_units += k > 0
        bg4 += k
        rest += len(sch) - k
    legs = len(COOP_LEGS) * (n - 1)  # receivers of each unit, all rounds
    want = {"bg4_fused_verify": [legs * bg4_units, legs * bg4],
            "blake3_chunks": [None, legs * rest]}
    fu = counts["bg4_fused_verify"]
    if fu != want["bg4_fused_verify"] or \
            counts["blake3_chunks"][1] != want["blake3_chunks"][1]:
        fail(f"phase 19c: kernel [launches, rows] {counts}; the rounds "
             f"received {want} ({len(units)} units a round, x{n - 1} "
             f"receivers, x{len(COOP_LEGS)} rounds)")
    if counts["bg4_regroup"][0]:
        fail(f"phase 19c: the standalone regroup ran {counts['bg4_regroup']}")

    rate = BENCH_COOP["dcn_bps"]
    if len(servers) != len(COOP_LEGS) * n:
        fail(f"phase 19c: {len(servers)} DCN servers, not "
             f"{len(COOP_LEGS) * n}")
    rows = []
    for i, srv in enumerate(servers):
        st = srv.stats
        wall = srv.closed - srv.opened
        if st.bytes_served != srv.received:
            fail(f"phase 19c server {i}: served {st.bytes_served:,} B, its "
                 f"peers received {srv.received:,} B")
        if srv._bucket is None or srv.charged != st.bytes_served:
            fail(f"phase 19c server {i}: served {st.bytes_served:,} B, "
                 f"charged its bucket {srv.charged:,} B")
        burst = srv._bucket.capacity
        span = (max(t1 for _t0, t1 in srv.charges)
                - min(t0 for t0, _t1 in srv.charges)) if srv.charges else 0.0
        need = (srv.charged - burst) / rate
        if span < need - 1e-3:
            fail(f"phase 19c server {i}: {srv.charged:,} B passed its "
                 f"bucket in {span:.3f} s, under ({srv.charged:,} - "
                 f"{burst:,}) B / {rate:,} B/s = {need:.3f} s")
        rows.append((st.connections, st.chunks_served, st.bytes_served,
                     st.not_found, round(wall, 3), round(span, 3),
                     round(need, 3), round(srv.waited, 3)))
    host0 = servers[-n].stats  # host 0 of the collective exchange
    print(f"phase 19c bench_coop_pull ({card_label()}): {r['model_bytes']:,}"
          f" B, {n} hosts, DCN shaped to {rate:,} B/s and "
          f"{BENCH_COOP['dcn_rtt_s']} s a window; baseline "
          f"{r['baseline']['wall_s']} s, coop {r['coop']['wall_s']} s "
          f"(peer-served {r['coop']['peer_served_ratio']}, speedup "
          f"{r['speedup']}), exchange p2p {r['exchange']['p2p_wall_s']} s vs "
          f"collective {r['exchange']['collective_wall_s']} s (speedup "
          f"{r['exchange']['collective_speedup']}); wire "
          f"{r['coop']['wire']}; kernel [launches, rows] {counts} = the "
          f"{len(units)} units' {bg4} BG4 and {rest} other chunks x{legs} "
          f"receipts; host 0's collective server stats {host0}; every "
          f"server's (connections, chunks, bytes, not_found, wall s, "
          f"charge span s, its bound (bytes - burst) / rate s, s waited in "
          f"the bucket) {rows}")
    return {k: nl for k, (nl, _rows) in counts.items()}


def bench_fleet_phase() -> None:
    """19d: ``bench_fleet`` at ``BENCH_FLEET``: every in-artifact gate."""
    from zest_tpu_torch import bench_scale

    t0 = time.monotonic()
    r = bench_scale.bench_fleet(**BENCH_FLEET)
    bad = [k for k, v in r["gates"].items() if v is False]
    if bad or not r["gates"]["all_ok"]:
        fail(f"phase 19d: bench_fleet gates {bad}: {r['gates']}")
    f = r["fleets"][str(BENCH_FLEET["fleet_sizes"][0])]
    print(f"phase 19d bench_fleet in {time.monotonic() - t0:.2f} s (a model, "
          f"no device): {f['hosts']} hosts in {f['pods']} pods, "
          f"peer-served {f['peer_served_ratio']}, federated speedup "
          f"{f['federated_speedup']}, gossip {f['gossip']['sweeps_to_converge']}"
          f" of {f['gossip']['sweep_bound']} sweeps; gates {r['gates']}")


def bench_phase(work: Path, dev) -> dict:
    """Phase 19: 19a–19d (above), the benches' temporary dirs under
    ``work``. Returns each path's launches by kernel: ``bench``,
    ``bench_gb`` and ``bench_coop``."""
    t0 = time.monotonic()
    saved, tempfile.tempdir = tempfile.tempdir, str(work)
    try:
        paths = {"bench": bench_cli_phase(dev)}
        paths["bench_gb"] = bench_gb_phase(dev)
        paths["bench_coop"] = bench_coop_phase(dev)
        bench_fleet_phase()
    finally:
        tempfile.tempdir = saved
    print(f"phase 19 wall {time.monotonic() - t0:.2f} s; launches by path "
          f"{paths}")
    return paths


def run(args, work: Path) -> dict:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from zest_tpu_torch import native
    from zest_tpu_torch.api.http_api import PublisherServer
    from zest_tpu_torch.cas import hashing
    from zest_tpu_torch.cas.xorb import XorbReader
    from zest_tpu_torch.config import Config
    from zest_tpu_torch.models.generate import load_generator
    from zest_tpu_torch.models.loader import load_checkpoint, params_digest
    from zest_tpu_torch.models.safetensors_io import write_safetensors
    from zest_tpu_torch.ops import bg4_cuda, blake3_cuda
    from zest_tpu_torch.ops import blake3 as plain
    from zest_tpu_torch.transfer.pull import pull_model
    from zest_tpu_torch.transfer.push import push_checkpoint

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)

    # ── 1. build ──
    dlog = PhaseLog()  # each phase's wall and remediation decisions
    sass = build_all(work)
    dlog.mark("phase 1")

    # ── 2. kernel vs plain vs native host BLAKE3, on the card ──
    chunks = [rng.bytes(n) for n in KERNEL_LENGTHS]
    for key in (None, hashing.CHUNK_KEY):
        got = blake3_cuda.CudaHasher(key, dev).hash_batch(chunks)
        want = plain.DeviceHasher(key, dev).hash_batch(chunks)
        host = [native.lib.blake3(c) if key is None
                else native.lib.blake3_keyed(key, c) for c in chunks]
        if got != want or got != host:
            fail(f"kernel digests disagree (keyed={key is not None})")
        words, lengths = plain.stage_batch(chunks, dev)
        raw = words.view(torch.uint8)
        junk = torch.randint(0, 256, raw.shape, device=dev,
                             dtype=torch.uint8)
        past = (torch.arange(raw.shape[1], device=dev)[None, :]
                >= lengths[:, None])
        dirty = torch.where(past, junk, raw).contiguous().view(torch.uint32)
        hasher = blake3_cuda.CudaHasher(key, dev)
        kd = hasher.hash_device(dirty, lengths)
        if not (torch.equal(kd, hasher.hash_device(words, lengths))
                and torch.equal(kd, plain.hash_words(
                    dirty, lengths, hasher.key_words, hasher.base_flags))):
            fail("garbage past a length changed a digest")
    torch.cuda.synchronize()
    print(f"phase 2 kernel == plain == native on {len(chunks)} lengths "
          f"(0-2049, every leaf count 1-128, the 32-leaf group edges), "
          f"plain and keyed, garbage-tolerant")
    bg4_phase(rng, dev)
    dlog.mark("phases 2, 2b")

    # ── 3. push (the kernel verifies every minted chunk) ──
    ckpt = work / "checkpoint"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(GPT2_CONFIG, indent=2))
    tensors = gpt2_checkpoint(args.seed, GPT2_CONFIG)
    n_params = sum(t.numel() for t in tensors.values())
    write_safetensors(ckpt / "model.safetensors", tensors)
    cfg_a = Config(hf_home=work / "a" / "hf", cache_dir=work / "a" / "zest")
    for c in (blake3_cuda.COUNTER, bg4_cuda.COUNTER, bg4_cuda.FUSED_COUNTER):
        c.reset()  # counts from here are the push path's
    pushed = push_checkpoint(cfg_a, REPO, ckpt, device="cuda", notify=False)
    push_launches = blake3_cuda.COUNTER.launches
    if push_launches < 1:
        fail("push never launched the BLAKE3 kernel")
    if blake3_cuda.COUNTER.rows != pushed.minted_chunks:
        fail(f"kernel hashed {blake3_cuda.COUNTER.rows} chunks, push minted "
             f"{pushed.minted_chunks}")
    print(f"phase 3 push: {n_params:,} params, {pushed.total_bytes:,} bytes "
          f"in {pushed.elapsed_s:.2f} s; {pushed.new_xorbs} xorbs, "
          f"{pushed.minted_chunks} chunks, kernel launches {push_launches}")

    publisher = PublisherServer(cfg_a).start()
    dlog.mark("phase 3")
    try:
        # ── 4. pull through node A's loopback publisher: the direct
        # streaming landing ──
        pulled, cfg_b, digest = pull_phase(work, publisher.url, cfg_a, ckpt,
                                           pushed, dev)
        tth_a = pulled.stats["time_to_hbm_s"]
        tfl_a = pulled.stats["time_to_first_layer_s"]
        dlog.mark("phase 4")

        # ── 4b. the same tensors as a three-shard checkpoint, tight ring ──
        sharded_launches = sharded_phase(work, publisher.url, cfg_a, tensors,
                                         digest, dev)
        tensors_b = revision_b(tensors, args.seed + 1)
        del tensors
        shutil.rmtree(work / "d")
        # ── 4c. phase 4's repo again: complete files stage from disk ──
        resume_phase(cfg_b, digest, dev)
        dlog.mark("phases 4b, 4c")

        # ── 5. greedy decode from the landed tree vs the CPU float32 run ──
        _, gen_cuda = load_generator(pulled.snapshot_dir, device="cuda",
                                     tensors=pulled.params)
        _, gen_cpu = load_generator(pulled.snapshot_dir, device="cpu")
        prompts = rng.integers(0, GPT2_CONFIG["vocab_size"], (4, 8)).tolist()
        gpt2_tokens = []  # the CPU float32 run's, for phase 14a
        for batch in ([prompts[0]], prompts):
            gen_cuda(batch, 2, stop_at_eos=False)  # warm-up (cuBLAS init)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            out = gen_cuda(batch, args.steps, stop_at_eos=False)
            dt = time.monotonic() - t0
            ref = gen_cpu(batch, args.steps, stop_at_eos=False)
            if not np.array_equal(out, ref):
                fail(f"batch {len(batch)}: cuda tokens != cpu tokens")
            gpt2_tokens.append((batch, ref))
            if len(batch) == 1:
                gpt2_b1 = (batch[0], out[0].tolist())  # for phase 9b
            print(f"phase 5 generate batch {len(batch)}: prefill 8 + "
                  f"{args.steps} steps in {dt:.3f} s, "
                  f"{len(batch) * args.steps / dt:.1f} tokens/s; equal to "
                  "CPU")
        del gen_cuda, gen_cpu  # node B's tree is the swap's base now

        # ── 5b. the revision hot-swap into phase 4's tree ──
        swap_ref = swap_phase(
            work, publisher.url, publisher, cfg_a, cfg_b, pulled,
            pushed.revision, tensors_b, prompts, args.steps,
            pulled.stats["time_to_hbm_s"], dev)
        delta_launches = swap_ref["launches"]
        dlog.mark("phases 5, 5b")
        del pulled, tensors_b  # free phase 4/5's trees
        shutil.rmtree(work / "b" / "hf")  # phase 8 seeds B's xorb cache
        torch.cuda.empty_cache()

        # ── 6. cooperative pull of revision A across in-process hosts:
        # the point-to-point exchange, then the collective over the wire
        # (6c) and through the device lane (6d) ──
        coop_launches = coop_phase(work, publisher.url, ckpt, pushed,
                                   cfg_a, digest, dev, pushed.revision,
                                   traced=True, coop_collective=False)
        collective_launches = coop_phase(
            work, publisher.url, ckpt, pushed, cfg_a, digest, dev,
            pushed.revision, label="phase 6c", schedule="hypercube")
        lane_launches = coop_phase(
            work, publisher.url, ckpt, pushed, cfg_a, digest, dev,
            pushed.revision, label="phase 6d", schedule="hierarchical",
            collective_backend="jax", coop_topology=(0, 0, 1, 1))
        # ── 20. the collective over a pod map, WAN-shaped servers ──
        wan_launches = coop_phase(
            work, publisher.url, ckpt, pushed, cfg_a, digest, dev,
            pushed.revision, label="phase 20", schedule="federated",
            shaping=WAN_SHAPING, coop_topology=WAN_SLICES,
            coop_pods=WAN_PODS)
        dlog.mark("phases 6, 6c, 6d, 20")
        torch.cuda.empty_cache()  # phase 4's and 6's trees are gone

        # ── 10. the pod round over four slots on cuda:0 ──
        pod_launches = pod_phase(work, publisher.url, ckpt, pushed, cfg_a,
                                 digest, dev, pushed.revision)
        dlog.mark("phase 10")
        torch.cuda.empty_cache()

        # ── 7. Llama-3.2-1B: push → pull → cached, sampled decode ──
        llama_ref = llama_phase(work, publisher.url, cfg_a, args.seed,
                                args.steps, dev)
        dlog.mark("phase 7")

        # ── 8. the swarm: node B seeds, fresh nodes pull from it ──
        swarm_launches = swarm_phase(work, publisher.url, cfg_b, ckpt,
                                     pushed, digest, tth_a, tfl_a, dev)
        dlog.mark("phase 8")

        # ── 15. peer discovery: tracker, DHT, gossip; the parallel rung ──
        discovery_launches = discovery_phase(work, publisher.url, cfg_b,
                                             ckpt, pushed, digest, dev)
        dlog.mark("phase 15")

        # ── 9. the serving pool in-process, then the daemon over HTTP, on
        # Llama-3.2-1B's width at two layers (9r: its push, landing and
        # reference) ──
        pool_ref = pool_llama_phase(work, publisher.url, cfg_a, args.seed,
                                    args.steps, dev)
        pool_out = pool_phase(work, publisher.url, cfg_a, pool_ref,
                              args.seed, args.steps, dev)
        daemon_launches = daemon_phase(
            work, publisher.url, pool_out, pool_ref["repo"],
            pool_ref["prompts"][0], gpt2_b1, pushed.revision, args.steps)
        dlog.mark("phase 9")

        # ── 11. the mesh landing and the tensor-parallel decode ──
        mesh_launches = mesh_phase(work, publisher.url, cfg_a, pool_ref,
                                   pool_out, args.steps, dev)
        del pool_ref
        shutil.rmtree(work / "l2")
        dlog.mark("phase 11")

        # ── 12. the training plane: GPT-2 AdamW with a train-state
        # checkpoint, the Llama-3.2-1B fine-tune pushed back and
        # delta-pulled, context and pipeline parallelism ──
        torch.cuda.empty_cache()  # every earlier phase's tree is gone
        print(f"phase 12 starts with {torch.cuda.memory_allocated(dev):,} B "
              "allocated on the card")
        gpt2_ref = gpt2_finetune_phase(ckpt, work, args.seed, dev)
        ft_ref = llama_finetune_phase(
            work, publisher.url, cfg_a, llama_ref, args.seed, args.steps, dev)
        finetune_launches = ft_ref["launches"]
        parallel_train_phase(args.seed, dev)
        dlog.mark("phase 12")

        # ── 13. the sharded tree's life cycle: the hot-swap over a slot
        # mesh, and tensor-, data-, context- and expert-parallel AdamW ──
        torch.cuda.empty_cache()
        print(f"phase 13 starts with {torch.cuda.memory_allocated(dev):,} B "
              "allocated on the card")
        mesh_swap_launches = mesh_swap_phase(work, publisher.url,
                                             pushed.revision, swap_ref, dev)
        sharded_train_phase(work, publisher.url, llama_ref, ft_ref, dev)
        tp_cp_phase(args.seed, dev)
        expert_train_phase(args.seed, dev)
        dlog.mark("phase 13")

        # ── 14. the multi-pod pull: the federated round across two pods,
        # the hierarchical distributor, the lossy cross-pod tier ──
        torch.cuda.empty_cache()
        fed_launches = federated_phase(
            work, publisher.url, cfg_a, ckpt, pushed, digest,
            {"tokens": gpt2_tokens, "steps": args.steps}, dev)
        hier_launches = hierarchy_phase(work, publisher.url, cfg_a, pushed,
                                        dev)
        lossy_launches = lossy_phase(work, publisher.url, ckpt, pushed, dev)
        dlog.mark("phase 14")

        # ── 16. the multi-tenant pull service: concurrent tenants, a
        # cancel mid-landing, the daemon's queue, eviction under pins ──
        torch.cuda.empty_cache()
        tenancy_launches = tenancy_phase(work, publisher.url, cfg_a, ckpt,
                                         pushed, digest, swap_ref,
                                         args.seed, dev)
        dlog.mark("phase 16")

        # ── 17. the self-healing control plane: a stalled seeder hedged,
        # a straggling collective aborted, the ring tuner and the pool
        # rules, the timeline and remediation surfaces ──
        torch.cuda.empty_cache()
        heal_launches = heal_phase(work, publisher.url, publisher, cfg_a,
                                   cfg_b, ckpt, pushed, digest, args.seed,
                                   dev)
        dlog.mark("phase 17")

        # ── 18. GPT-2's sharded step: a mesh pull with its pre-pass,
        # params_from_hf's one sharded tree, two AdamW steps against 12a,
        # tensor-parallel decode of the trained tree ──
        torch.cuda.empty_cache()
        mesh_train_launches = sharded_gpt2_phase(
            work, publisher.url, pushed.revision, gpt2_ref, prompts,
            args.steps, dev)
        del gpt2_ref
        dlog.mark("phase 18")

        # ── 19. zest bench, a GB pull at full Llama-8B width, the shaped
        # cooperative bench and the fleet model ──
        torch.cuda.empty_cache()
        bench_launches = bench_phase(work, dev)
        dlog.mark("phase 19")
    finally:
        publisher.close()
    receipt_timing(cfg_a, pushed, dev)

    # ── kernel timing at the push path's shapes ──
    blob = max((cfg_a.xorb_cache_path(h).read_bytes()
                for h in pushed.xorb_digests), key=len)
    reader = XorbReader(blob)
    decoded = bytearray(sum(int(s) for s in reader.chunk_sizes))
    reader.extract_range_into(0, len(reader), decoded)
    sizes = reader.chunk_sizes.astype(np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    batch = [memoryview(decoded)[offs[i]:offs[i + 1]]
             for i in range(len(sizes))]
    words, lengths = plain.stage_batch(batch, dev)
    hasher = blake3_cuda.CudaHasher(hashing.CHUNK_KEY, dev)
    kernel_out = hasher.hash_device(words, lengths)
    plain_out = plain.hash_words(words, lengths, hasher.key_words,
                                 hasher.base_flags)
    max_err = max_abs_err(kernel_out, plain_out)
    if max_err:
        fail("kernel != plain at the push shapes")
    ms = cuda_ms(lambda: hasher.hash_device(words, lengths), 50)
    plain_ms = cuda_ms(lambda: plain.hash_words(
        words, lengths, hasher.key_words, hasher.base_flags), 3)
    nbytes, n_compressions = blake3_work(sizes)
    alu, fma = sass
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = op_ms(n_compressions * alu, n_compressions * fma)
    src_ms = (n_compressions * SOURCE_OPS_PER_COMPRESSION
              / INT32_OPS_PER_S * 1e3)
    print(f"blake3 kernel at push shapes: {len(batch)} chunks, cap "
          f"{words.shape[1] * 4} B, {int(sizes.sum()):,} bytes: {ms:.4f} ms "
          f"({sizes.sum() / ms / 1e6:.1f} GB/s of chunk bytes), plain "
          f"{plain_ms:.2f} ms, bound {max(byte_ms, ops_ms):.4f} ms "
          f"(bytes {byte_ms:.4f}: {nbytes:,} B; ops {ops_ms:.4f}: "
          f"{n_compressions:,} compressions x ({alu} ALU + {fma} FMA); "
          f"{src_ms:.4f} at the source's {SOURCE_OPS_PER_COMPRESSION} per "
          f"compression)")
    kernels = [{
        "name": "blake3_chunks",
        "route": "cuda",
        "source": "zest_tpu_torch/csrc/blake3.cu",
        "replaces": "zest_tpu/ops/blake3_pallas.py:332",
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(byte_ms, ops_ms),
        "bound_by": "bytes" if byte_ms > ops_ms else "operations",
        "library_ms": None,
    }] + time_bg4(cfg_a, pushed, dev, sass)
    by_path = {"blake3_chunks": {"push": push_launches,
                                 "push_sharded": sharded_launches,
                                 "push_delta": delta_launches,
                                 "push_llama": llama_ref["launches"],
                                 "push_pool_llama": pool_out["llama_push"],
                                 "push_finetune": finetune_launches,
                                 "push_mixtral": pool_out["push_launches"],
                                 "serve": pool_out["launches"][
                                     "blake3_chunks"],
                                 "serve_daemon": daemon_launches[
                                     "blake3_chunks"],
                                 "coop": coop_launches["blake3_chunks"],
                                 "coop_collective": collective_launches[
                                     "blake3_chunks"],
                                 "coop_collective_lane": lane_launches[
                                     "blake3_chunks"],
                                 "coop_wan": wan_launches["blake3_chunks"],
                                 "pod": pod_launches["blake3_chunks"],
                                 "mesh": mesh_launches["blake3_chunks"],
                                 "mesh_swap": mesh_swap_launches[
                                     "blake3_chunks"],
                                 "swarm": swarm_launches["blake3_chunks"],
                                 "federated": fed_launches["blake3_chunks"],
                                 "hier": hier_launches["blake3_chunks"],
                                 "lossy": lossy_launches["blake3_chunks"],
                                 "mesh_train": mesh_train_launches[
                                     "blake3_chunks"]}}
    phase_paths = {**discovery_launches, **tenancy_launches,
                   **heal_launches, **bench_launches}
    for path, counts in phase_paths.items():
        by_path["blake3_chunks"][path] = counts["blake3_chunks"]
    for k in kernels:
        paths = by_path.get(k["name"], {"coop": coop_launches[k["name"]],
                                        "coop_collective":
                                            collective_launches[k["name"]],
                                        "coop_collective_lane":
                                            lane_launches[k["name"]],
                                        "coop_wan": wan_launches[k["name"]],
                                        "pod": pod_launches[k["name"]],
                                        "mesh": mesh_launches[k["name"]],
                                        "mesh_swap": mesh_swap_launches[
                                            k["name"]],
                                        "swarm": swarm_launches[k["name"]],
                                        "federated": fed_launches[k["name"]],
                                        "hier": hier_launches[k["name"]],
                                        "lossy": lossy_launches[k["name"]],
                                        "mesh_train": mesh_train_launches[
                                            k["name"]],
                                        "serve": pool_out["launches"][
                                            k["name"]],
                                        "serve_daemon": daemon_launches[
                                            k["name"]],
                                        **{path: counts[k["name"]]
                                           for path, counts in
                                           phase_paths.items()}})
        k["launches"] = sum(paths.values())
        k["launches_by_path"] = paths
    dlog.mark("kernel timing")
    return {"kernels": kernels}, dlog.walls


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=32)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    t0 = time.monotonic()
    work = Path(tempfile.mkdtemp(prefix=".smoke-",
                                 dir=Path(__file__).resolve().parent))
    try:
        record, walls = run(args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    card = card_label()
    print(f"chip_smoke wall {time.monotonic() - t0:.1f} s ({card}); by "
          f"phase {json.dumps(walls)}")
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
