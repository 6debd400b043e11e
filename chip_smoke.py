"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--out report.json] [--against PARENT_CHECKOUT [--changed KEYS]]

Phases, each of which fails the run (nonzero exit) on a miss:
  1. device   needs CUDA; prints the card's name and power limit
  2. build    compiles the port's CUDA kernels with nvcc from the checkout,
              one nvcc per source, all started together; with --against,
              also both trees afresh (repro_torch.kernels.build.compare),
              printing the verdict and failing unless every kernel both
              compile has an identical ptxas report, apart from those a
              change names on purpose with --changed (substrings of
              "<source> <kernel>": for example a redesigned kernel's
              source)
  3. kernels  every kernel against its plain PyTorch version, bf16 and f32,
              at qwen1.5-0.5b's shape (KV=16, G=1, Dh=64, page 16) and at a
              GQA shape (KV=8, G=4, Dh=128): B1 paged_decode and B2
              paged_prefill on the layouts of the CPU tests (permuted pages,
              a poisoned null page, ragged and empty rows, partial last
              pages), each B1 call on its route (widths that are multiples
              of 16 the ring kernel, either dtype; Dh 24 and 12 the sweep),
              and B1 at the served decode's capacity (8 rows over 64 pages
              of 16, lengths 0, 1, on 16-key tiles and full) at both shapes
              and at jamba's (KV 8, G 8, Dh 128) with the planned and with
              the most cluster ranks; B5
              paged_cpq_decode and B6 paged_cpq_prefill over CPQ code pages
              of 4 and 8 bits, L = 4 levels, with the null page's
              levels out of range, a live row over an all-null block row
              (each B5 call must take its route: widths that are multiples
              of 16 the single-query kernel, Dh 24 and 12 the sweep);
              B2 and B6 on prompt chunks of 16 at offset 0, mid-prompt, at a
              mid-page offset, far in and with valid < C, and chunks of 8
              (fewer than 16 query rows), also at Dh 24 and 12: each call
              must take its route (bf16 at widths that are multiples of 8
              the tensor-core kernel, float32 and Dh 12 the sweep), and the
              log names each error's route;
              B3 paged_decomposed_decode and B4 paged_decomposed_prefill on
              the same layouts and chunks at qwen1.5-0.5b's T1 shape (H=16,
              Dm=1024, 16 roped keys of 32), an MLA-like shape (H=16,
              Dm=512, one shared roped key of 64), a no-rope shape (H=8,
              Dm=256) and past d_model 2048 (Dm 2560, 3072, 4096, 8192),
              each B3 and B4 call on its route (bf16 up to Dm 1024 the
              tensor-core kernel, float32 and wider models the sweep), and
              B3 at the served shape over 8 rows of 64 pages with lengths
              on its split boundaries, 0 and the full capacity, with the
              planned and with the most splits; B7
              paged_proxy_scores (one launch forming the query factors from
              q in float32 or bf16, rows at a wider query's stride, its
              scale given or not, and the slot's float32 tables; int8
              codes) at qwen1.5-0.5b's T3 shape (KV=16, G=1, Dp=64) and GQA
              shapes (KV=8, G=4 and G=3, Dp=128) on the same layouts, and
              in its contiguous form (the factors given, and formed from a
              bf16 query as the static T3 decode does), held to 1e-5 x max
              |score|; the contiguous kernels: B8
              flash_attention (a bf16 prompt on its tensor-core route, a
              float32 prompt on its CUDA-core sweep, a decode token on its
              single-query route) on the five cases of tests/test_kernels.py,
              qwen1.5-0.5b's static prefill (8 x 512 tokens, causal), a
              one-shot prompt (1 x 512), a decode token over 575 keys (a
              prefix of a 576-key arena), each also at jamba's 64 heads over 8
              of Dh 128 as serve (o) runs them (with its static prefill of 8 x
              512), T = S = 77, at llama-vision's cross-attention (32 heads
              over 8 of 128: 8 x 512 and 1 x 77 prompts over 1600 patch
              keys, non-causal, and a decode token over them), at musicgen's
              32 heads of 64 (its static prefill of 8 x 512 and its last
              static decode), and at Dh
              32, 64, 128 and 256 with G of 1, 4 and 8 a prompt of 200
              (causal and not) and a decode token; in bf16 each B8 case is
              held against attention worked in float64 from the same bf16
              inputs, within the bf16 tolerance and no farther from it than
              the plain version; B9 decomposed_decode at
              qwen's T1 shape
              (kv_r 16, Rr 32, length < N, past one key split, length 0),
              an MLA-like shape (kv_r 1, Rr 64), a no-rope shape, 32 heads,
              N = 77, Dm 2560-8192 and musicgen's static decode (H 32, Dm
              2048, no rope), each call on its route (as B3's);
              B10 cpq_decode
              with 4- and 8-bit codes, G of 1, 4 and 8 (Dh 256), tiles
              rounded and not, pruned codes, length < N, N = 77 and
              musicgen's KV 32 (float32 output, its tolerance); B2 at the speculative verify chunk's
              shapes (C = 2, 5, 9 rows, valid = C or 3, at offsets 0, 1,
              15, 17 and 1024 - C, G 1 and 2, over a draft's block row:
              another slot's pages, then scratch pages seeded with the
              frontier page's payload), each call on its route; and at
              deepseek-v2-lite's MLA shapes (16 heads over the latent of
              512 and one roped key of 64 shared by every head): B3 and B4
              on the layouts above (chunks of 16), B3 at the served rows
              with the planned and the most splits, B9 at the static MLA
              decode (8 x 576, lengths 575, 193 and 0), and B8's prompt at
              Dh 192 / Dv 128 (16 heads, T up to 512, causal and not), each
              call on its route (bf16: the tensor cores)
  4. serve    full-width qwen1.5-0.5b (24 layers, vocab 151936, random
              weights from a seed) in bf16 through ContinuousServeEngine:
              8 greedy requests, prompts of 64-512 tokens, 64 new tokens
              each, (a) dense, (b) mode="cpq", (d) mode="decomposed" (T1),
              (e) mode="retrieval" (T3, top_k=256, recent_window=64: rows
              past 256 keys really select), (c) the tiered engine
              (enable_escalation=True, a dense arena small enough that rows
              are admitted into and escalated to the CPQ tier). Each run
              must launch its kernels 24 times per tick (T3: B7 per decode
              tick, B2 per chunk tick), every chunk launch of B2, B4 and B6
              and every decode launch of B3 on the tensor-core route, every
              decode launch of B5 on the single-query route and every decode
              launch of B1 on the ring route (route counters against
              launches; B1's also in (g));
              (a), (b), (d) and (e) then time
              them at the shapes the run gave
              them, beside their bound, their plain version and one PyTorch
              library call (a yardstick only); each run is replayed under
              torch.profiler over a window of decode-only ticks, (a), (b)
              and (d) also over a window of chunk ticks (10, 5 and 5). Then the
              contiguous path: (f)
              the static ServeEngine on 8 prompts of 512 seeded tokens, 64
              new tokens, in the four modes: B8 launched 24 times for the
              prefill, and 24 times per decode step B8 (dense), B9
              (decomposed), B10 (cpq) or B7's contiguous form (retrieval);
              every bf16 prefill through B8's tensor-core route, every
              dense decode step through its single-query route and every B9
              launch through its tensor-core route (counted per route); B8
              (prompt and decode shapes), B9 and B10 timed at the shapes the
              runs gave them, ten dense and ten decomposed decode steps
              profiled; (g) ContinuousServeEngine with prefill_chunk=0
              (one-shot admission), dense, on the traffic of (a): B8's
              tensor-core route 24 times per admission, B1 24 times per
              decode tick, B2 never. Then the rest of the continuous tick on
              (a)'s arena at the first REST_DEPTH = 12 of qwen's 24 layers,
              B1 and B2 alone launched (once a layer a decode step, a chunk
              or a verify chunk; every chunk on B2's tensor cores,
              every decode on B1's ring) and no page leaked: (h) prefix
              sharing with copy-on-write and defrag every 4 retirements on
              make_templated_workload (8 sessions of 3 turns behind one
              256-token system prompt; sessions 0, 2, 4, 6 sampled at
              temperature 0.8, top-k 50, top-p 0.9, seed 100 + rid): prefix
              hits and defrags; its prompts diverge at page boundaries, so
              a probe behind the same system prompt (a request diverging 10
              tokens into a page) must split a shared page (copy-on-write);
              (i) speculative decoding (spec_len 4, n-grams of 3) on
              make_loopy_workload (8 greedy requests, a 32-token motif
              tiled 4 times, 64 new tokens): verify steps and accepted
              drafts; (j) make_slo_workload (24 requests, interactive and
              batch classes) through the port's run_trace under the slo
              and fifo policies, with per-class tails. Then (r) the
              replica router at full width (all 24 layers, bf16): a
              ReplicaRouter over 2 replicas with (a)'s ServingCfg and the
              reference fault tests' probe settings (probe_interval 2,
              probe_failures 2, probe_backoff 2, auto_drain), load
              placement, 16 requests ((a)'s 8 and 8 more from the next
              seed, every third sampled at temperature 0.8, top-k 50, seed
              100 + rid; two arrivals a tick): (r1) no fault, the router
              built from host leaves (the device grows by at most 1.05
              weight copies, and every weight leaf of replica 1 is replica
              0's); (r2) a crash window at tick 16 for 4 ticks of replica
              1's fault clock: one auto-drain, one recovery, requests
              migrated, and the drain frees at least the drained arena's
              bytes of device memory; (r3) one decoding and one
              mid-prefill request of replica 0 rebalanced to replica 1.
              Each run: every rid in results() once with its 64 tokens, its
              events the gapless indices 0-63 once each with one finishing
              event, no page leaked on a live replica, B1 (ring) and B2
              (tensor cores) alone launched, 24 times a replica decode
              step and chunk; the router's step times, decode and end-to-end
              rates and stats()'s tokens_per_step printed (on one card the
              replicas tick one after the other; stats() counts them as
              parallel). No gate: layer 0's K/V of the static
              prompts encoded by the HQE compression (448 tokens at once,
              64 appended) and the T3 proxy encode on the card and on the
              CPU, and how many codes, levels and tables differ
  5. parity   the same requests in f32 (TF32 off), dense, mode="cpq",
              mode="decomposed" and mode="retrieval" (top_k=256), with the
              kernels on and off: prefill and first-decode logits within
              1e-3, greedy streams identical except where the gather path's
              top-2 logit gap is below 1e-4. T3 also prints (no gate) how
              many (row, head, layer) top-k sets picked by B7's scores differ
              from those picked by its plain version's and by the gather
              path's scores over sampled decode calls; its gather path
              attends the keys the kernel path picked, and every pick of its
              own that differs must be a swap within 1e-4 (relative) of the
              top-k boundary. Dense and decomposed run each path on its own
              history; CPQ and T3 run them in lockstep on one history (the
              gather path writes the K/V the kernel path wrote), since each
              path's 4-bit CPQ or 8-bit proxy codes would otherwise turn
              last-ulp K/V differences into whole steps. These continuous
              serves run the first 4 of the 24 layers here, to keep the
              script well inside its time limit. Then, at the same depth,
              the same checks for (g) (dense, each path on its own history)
              and for (f) in the four modes (CPQ and T3 in lockstep, T3
              pinned): the prefill and first-decode logits of the batch,
              and the greedy streams. Then (h), its copy-on-write probe and
              (i) at the parity depth, kernels on and off: identical greedy
              and sampled streams (greedy near-ties excused as above) and
              identical counters; sharing on against off and speculation
              on against off: identical streams. Last, the sampler on the
              card against the CPU on 32 rows of 151936 float32 logits:
              identical Threefry bits and uniforms, and identical draws but
              where the CPU's top-2 perturbed logits lie within 1e-6
              (relative), counted. Then (r2) and (r3) at 2 of the 24
              layers (ROUTER_PARITY_DEPTH, cut from the parity depth for
              time), kernels on, against one fault-free
              ContinuousServeEngine with (a)'s settings on the same 16
              requests: sampled streams identical, greedy streams
              identical but below a 1e-4 top-2 gap (excused, counted).
              Each added phase prints its seconds
  6. deepseek (k) deepseek-v2-lite at its published widths (27 layers: MLA
              with a latent of 512, one MLA + dense layer and 26 MLA + MoE,
              64 routed and 2 shared experts, top-6; random bf16 weights
              from a seed, ~32 GB) on ContinuousServeEngine over (a)'s
              arena, one-shot (a MoE stack), on (a)'s traffic: mode
              decomposed (the latent: B8's prompt route 27 times an
              admission, B3 on its tensor cores 27 times a decode tick) and
              mode cpq (the latent in CPQ codes: B8 alone), then the static
              ServeEngine on 8 prompts of 512, 64 new (B8 27 times, B9 on
              its tensor cores 27 times a step); its f32 parity, kernels
              on and off, over its first PARITY_DEPTH layers (the model
              freed first): logits within 1e-3, then streams and counters
              identical, or, where they differ, the first router call whose
              top-k sets differ no later than the first tick whose tokens
              differ and a near tie (relative top-k boundary gap below
              1e-5), counted; (l) qwen1.5-0.5b cut to DCPQ_DEPTH = 6 of its
              24 layers in mode decomposed_cpq
              (T1+T2: X in CPQ codes), chunked on (a)'s arena and static (no
              kernel: the reference has none for this tier; B8 prefills
              the static batch); (m) deepseek-moe-16b at its published
              widths cut to MOE_DEPTH = 4 layers (1 dense, 3 MoE), mode
              dense, asked for chunks but admitted one-shot (B8's prompt
              route, B1's ring), and its f32 parity as (k)'s. Each serve's launch counts are
              set to 0 just before it and read just after
  7. recurrent (n) xlstm-125m at its published widths, nothing cut (12
              layers: 2 x [5 mLSTM, 1 sLSTM], d_model 768, 4 heads,
              proj_factor 2, chunk 256, vocab 50304; random bf16 weights
              from a seed, ~0.39 GB) on ContinuousServeEngine over (a)'s
              arena and traffic, asked for chunks of 16 but admitted
              one-shot at each prompt's exact length (no chunk, no kernel:
              the stack has no attention), its slot states (~23.8 MB a
              slot) the whole arena; and on the static ServeEngine (8 x
              512, 64 new); its f32 parity, the card against the CPU
              running the same port code, on 2 of the 8 requests. The
              sLSTM's recurrence is chaotic at these random weights (a
              1e-7 nudge of the embeddings moves the CPU's own logits by
              O(1) over a 64-token prompt, printed), so the whole stack is held
              one decode step at a time from the CPU's state, the CPU's
              static decode_step against the card's continuous
              decode_step_rows over a 2-slot state tree (64 steps a request:
              logits and the states written in place within 1e-3, the
              argmax the CPU's but below a 1e-4 top-2 gap), and the stack of its 10 mLSTM layers alone
              free-running through ContinuousServeEngine on the card and on
              the CPU (prefill and first-decode logits within 1e-3, greedy
              streams identical but below a 1e-4 top-2 gap). (o)
              jamba-1.5-large-398b at its
              published widths (d_model 8192, 64 heads over 8 of 128, d_ff
              24576, Mamba d_state 16 / d_conv 4 / expand 2, 16 experts
              top-2 of 24576, vocab 65536), its depth cut to the first 5
              layers of its block of 8 (mamba+dense, mamba+moe, mamba+dense,
              mamba+moe, attn+dense; 48.1 GB bf16: one block is 90.5 GB, more
              than the card), mode dense, one-shot on (a)'s arena and
              traffic (B8's prompt route once an admission, B1's ring once a
              decode tick, B1 timed at that shape) and static (B8's prompt
              route once, its single-query route once a step, both timed);
              its f32 parity, kernels on and off, with the routed experts
              cut to 8 of 16 (top-2 kept; 57.5 GB, the bf16 model converted
              leaf by leaf), under (k)'s gates and router-tie excuse. The
              phase prints its seconds
  8. multimodal (p) llama-3.2-vision-11b at its published widths, nothing
              cut (40 layers: 8 blocks of attn, attn, attn, xattn, attn;
              d_model 4096, 32 heads over 8 of 128, SwiGLU d_ff 14336, vocab
              128256, untied, rope theta 500000; random bf16 weights from a
              seed, 9.79 B parameters, ~19.6 GB), every cross-attention gate
              set to 1.0 (the reference draws it at 0, where the layer adds
              nothing), on the static ServeEngine: 8 prompts of 512 seeded
              tokens, each row its own 1600 patches of N(0, 1), 64 new; B8's
              prompt route 40 times a prefill (32 causal, 8 non-causal over
              the patch keys) and its decode route 40 times a step (8 over
              the patch keys), both cross-attention shapes timed; arena
              bytes by the arithmetic. (q) musicgen-large at its published
              widths, nothing cut (48 layers, d_model 2048, 32 heads of 64,
              GELU d_ff 8192, layernorm, absolute positions, vocab 2048;
              ~4.85 GB), 8 rows of 512 frames of 0.3 N(0, 1), 64 new codes,
              modes dense (B8), decomposed (B9, every launch on its sweep:
              d_model 2048; its arena half of dense's), cpq (B10) and
              retrieval (B7's contiguous form, top_k 256), each step kernel
              timed. Then each model's f32 parity over its first
              PARITY_DEPTH layers (the bf16 model freed first; llama's
              include its first cross-attention layer), kernels on and off
              under phase 5's gates; llama's again with its patches scaled
              by 3 and shifted by 1, and how far that moves its logits (the
              cross-attention is live: more than 1e-2); musicgen's T1 logits
              within 3e-4 of its dense ones (exact at absolute positions).
              The phase prints its seconds
  9. train    (t1) qwen1.5-0.5b at its published widths, nothing cut (24
              layers; random bf16 weights from a seed) trained through the
              port's entry points (make_train_step, AdamW on
              cosine_schedule, remat, SyntheticLMData) for 12 steps of 4 x
              2048 tokens: past 1024 positions every layer takes flash
              attention and its custom backward (plain PyTorch, as the
              reference's is plain jnp). Gates: every loss finite, the loss
              falls, and no kernel wrapper or route counter of B1-B10
              moves (the reference's training launches no Pallas kernel
              either; the counts are set to 0 just before and read just
              after). Prints the step's median wall time, training
              tokens/s, peak device memory and the share of the card's
              bf16 peak, beside the card's name and power limit, and a
              profile of one more step (device time by kernel). (t2) the
              flash backward against autograd through dense_attention,
              both on the card in float32, at qwen's heads (16 of 64),
              jamba's (64 over 8 of 128), MLA's (Dh 192, Dv 128) and a
              cross-attention's (non-causal, 512 over 1600 keys), causal
              and not, T = S = 2048 and T != S with a q_offset: dq, dk, dv
              within 5e-5 of the largest gradient. (t3) the smoke config at
              float32: a train step on the card against the CPU
              (gradients, loss and parameters within 1e-4), AdamW's update
              of one set of gradients on both, and on the card remat
              against none, two microbatches against one and a
              checkpoint resume against a straight run (within 1e-5).
              The phase prints its seconds
 10. tune     (u1) B1, B2, B5 and B6 against their plain versions, bf16
              and f32, at the tuner's smoke heads (KV 4, G 1, Dh 16) on
              pages of 4 and 8 and chunks of 4, 8, 32 and 64 rows, on
              phase 3's layouts, each call on its route, under phase 3's
              tolerances; (u2) the port's ServingObjective on the card and
              on the CPU, the qwen1.5-0.5b smoke config at float32 with
              the same weights, over five genomes (the default; spec_len 2
              under slo; escalation on pages of 4; chunks of 4 pages of
              16; escalation on pages of 4 in chunks of one page from one
              row's arena, where rows are admitted into the CPQ tier):
              objective tuples and metrics identical, B1 and B2 launched,
              B5 by the tiered genomes, B6 by the last; the objectives
              depend on scheduling alone, so each trace is then served
              again on either side and its greedy streams compared
              (identical, or a first divergence at a CPU top-2 logit gap
              below ARGMAX_GAP); (u3) the tune entry
              point (--smoke, 12 evaluations, bf16, written to a temporary
              file): its own contract, B1 and B2 on their bf16 routes, no
              committed presets file touched, evaluations a second; (u4)
              the serve entry point at full width (qwen1.5-0.5b, random
              bf16 weights from a seed, 8 prompts of 64, 32 new):
              --continuous with each committed preset (default, latency,
              throughput, energy), --continuous --mode decomposed,
              retrieval and cpq, static --mode cpq and --continuous
              --replicas 2 --inject-faults 0: output shapes, the kernels
              each launches on their bf16 routes, and the default preset's
              greedy output identical to a ContinuousServeEngine built with
              the same ServingCfg, weights and batch; tokens/s of each run
              beside the card's name and power limit. The phase prints its
              seconds
 11. mesh     the serving mesh (serving/sharded.py; model shards on
              distinct cards where the machine has them, else all on the
              one card): (v1) the kernels at the shapes a model shard
              launches them, bf16 and f32, on phase 3's layouts, each call
              on its route, under phase 3's tolerances: B1, B2, B5 and B6
              at KV 8 and 4 (G 1, Dh 64), B3 and B4 at H 8 over Dm 1024
              with 8 roped keys of 32 and over the MLA latent of 512 with
              its one roped key of 64, B7 at KV 8; B3 and B4 in bf16 over
              2 and 4 head shards of qwen's T1 call (and 2 of MLA's), each
              planned as the whole call, equal to the whole call bit for
              bit; (v2) full-width
              qwen1.5-0.5b in bf16 on ContinuousServeEngine with phase 4's
              8 requests and arenas: dense and decomposed over
              make_serve_mesh(1, 2) at all 24 layers against phase 4's
              serves (a) and (d), then cpq, retrieval and tiered over
              (1, 2) and dense over (1, 4) at the first MESH_DEPTH = 4
              layers (cut for time; --mesh-depth 24 runs them whole, as
              PERF.md records) against unsharded serves of those layers
              made here (phase 4's at 24): each
              tier's kernel launched layers x mp times a tick on phase 4's
              routes, the greedy streams identical to unsharded (a first
              divergence excused only at an unsharded top-2 gap below
              ARGMAX_GAP), model_shards, arena_bytes_per_device x mp =
              arena_bytes_total and the interconnect bytes by the
              reference's accounting; the decode tick's median and p90 and
              decode tokens/s beside unsharded, with the card's name and
              power limit; on two cards or more each card's
              memory_allocated; (v3) float32 at PARITY_DEPTH layers,
              sharded against unsharded on the card, dense and decomposed:
              first logits within 1e-5, streams identical as (v2); then
              the card's sharded engine against the CPU's (shards sharing
              the CPU), dense: first logits within 1e-3, two requests'
              streams identical but for a CPU near tie below ARGMAX_GAP;
              (v4) deepseek-v2-lite at its published widths cut to
              MOE_DEPTH layers, one-shot, over (1, 2): B3 once a shard a
              layer a decode tick over the latent gathered whole, on its
              tensor cores in bf16 and its sweep in float32; in both
              dtypes streams identical to the unsharded engine's as (v2);
              (v5) flash decoding, the ring
              scores and GPipe over CUDA shards against one device at
              tests/test_distributed.py's sizes (1e-5, 2e-4, 1e-6), flash
              decoding also at qwen1.5-0.5b's decode shape in bf16 (2e-2);
              (v6) the serve entry point with --mesh 1,2: at full width on
              two cards, refused on one naming the count. The phase prints
              its seconds
 12. train mesh the training mesh (train/sharded.py: FSDP storage by the
              reference's specs, the ZeRO-3 step over the data replicas;
              every position on the one card): (w1) full-width
              qwen1.5-0.5b at float32 over Mesh(data 2, model 2), phase 9's
              4 x 2048 tokens, deterministic algorithms on: an SGD-probe
              step against the unsharded step in one pass and over the
              mesh's own split of the rows (2 microbatches); 3 AdamW and 3
              Adafactor steps against the unsharded step over that split:
              every loss, and after the last step the parameters and every
              state tensor, each within phase 9's TRAIN_TOL a tensor
              (Adafactor's bf16 first moment within one bf16 step more);
              then bf16 AdamW, 3 steps each way, the step times beside
              each other; (w2) python -m
              repro_torch.launch.train --mesh single --device cuda:0 (256
              shards at full width, 2 steps of 16 x 512) against --mesh
              none: final losses within 1e-3 relative, step times and peak
              memory; --mesh multi (512 shards) at --smoke likewise; (w3)
              compressed_psum over 8 shards of the card against the CPU,
              the reference test's 20 steps: codes identical, its drift
              bound; (w4) the sharded parameters and AdamW state at every
              position of the (16, 16) mesh equal launch.dryrun's
              per-device bytes. No kernel of B1-B10 is launched (the counts
              are set to 0 before and read after). The phase prints its
              seconds

The last line is {"ok": true, "device": {...}}; the line before it lists
every kernel with its launches, error and times.
"""
from __future__ import annotations

import argparse
import ast
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
BF16_FLOPS = 989e12         # H100 SXM dense bf16 tensor-core peak
F32_FLOPS = 67e12           # H100 SXM float32 outside the tensor cores
TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}  # kernel vs plain, max abs
LOGIT_TOL = 1e-3            # f32 logits, kernels vs gather path (atol = rtol)
ARGMAX_GAP = 1e-4           # top-2 gap below which a greedy tie is excused
TOPK_GAP = 1e-4             # T3: relative proxy-score gap below which a top-k swap is a tie
CPQ_LEVELS = 4              # HQE levels of the default CPQCfg
PARITY_DEPTH = 4            # layers of every serve's f32 parity (of 24; deepseek-v2-lite's 27)
REST_DEPTH = 12             # layers of serves (h)-(j) (of 24; cut to make room for phase 8)
SEED = 0
DEVICE = "cuda"
# the namespaces of the attention kernels' device functions, as a profile
# names them
ATTENTION_KERNELS = ("paged_attn", "paged_chunk", "paged_token", "cpq_attn",
                     "decomposed_attn", "decomposed_chunk", "t1_token", "topk_retrieval",
                     "flash_prompt", "single_query")
# B8's wrapper counts every launch; its kernels (routes) are counted apart,
# under these names in a serve's launch counts
COUNT_KEY = {"flash_attention": "flash_attention/decode",
             "flash_attention_prompt": "flash_attention/prompt"}
T0 = 0.0                    # start of the run, for phase timestamps


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


LOG: list[str] = []         # every logged line, kept for the --out report


def log(msg: str) -> None:
    LOG.append(msg)
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of one ``fn()`` over ``reps`` runs (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# --------------------------------------------------------- phase 3: sweeps


def layout(rng, B, nb, page):
    """Ragged lengths (an empty row, partial last pages) over permuted
    physical pages; unmapped entries stay at the null page 0."""
    num_pages = 1 + B * nb + 3
    lengths = rng.integers(0, nb * page + 1, size=B).astype(np.int32)
    lengths[0] = 0
    lengths[-1] = nb * page - page // 2        # long row, partial last page
    perm = list(rng.permutation(np.arange(1, num_pages)))
    bt = np.zeros((B, nb), np.int32)
    for b in range(B):
        for j in range(-(-int(lengths[b]) // page)):
            bt[b, j] = perm.pop()
    return num_pages, lengths, bt


def chunk_calls(long_len: int, C: int = 16) -> tuple:
    """(offset, valid, C) of the prompt chunks a sweep runs over a long row:
    a first chunk, valid < C, a mid-page offset, a chunk far in, the row's
    last tokens, and chunks of 8 (fewer than 16 query rows at G = 1)."""
    return ((0, C, C), (C, 5, C), (213, C, C), (512, C, C), (long_len - 3, 3, C),
            (37, 8, 8), (300, 5, 8))


def routes_moved(routes: dict, before: dict) -> dict:
    """The launches of each route of a kernel (``routes``, its module's
    counter dict) since ``before``."""
    return {r: n - before[r] for r, n in routes.items()}


def decode_err(ops, dtype, q, kp, vp, bt, lengths, scale) -> float:
    """Max abs error of one B1 call against its plain version; the call must
    take the route its dtype and widths pick, and its empty rows be zero."""
    before = dict(ops.DECODE_ROUTE_LAUNCHES)
    out = ops.paged_decode(q, kp, vp, bt, lengths, scale)
    torch.cuda.synchronize()
    route = ops.decode_route(dtype, kp.shape[-1], vp.shape[-1], bt.shape[1])
    moved = routes_moved(ops.DECODE_ROUTE_LAUNCHES, before)
    check(moved == {k: int(k == route) for k in moved},
          f"paged_decode {dtype} {tuple(kp.shape)}: routes {moved}, want {route}")
    ref = ops.paged_decode_plain(q, kp, vp, bt, lengths, scale)
    check(not out[lengths == 0].any().item(), "paged_decode: an empty row is not zero")
    return (out.float() - ref.float()).abs().max().item()


# B1 at the served decode's capacity (8 rows over 64 pages of 16): lengths
# 0, 1, on the ring route's 16-key tiles and at the full capacity, at
# qwen1.5-0.5b's shape (KV 16, G 1, Dh 64: one block a unit), at GQA (KV
# 8, G 4, Dh 128: two ranks a unit) and at jamba's (KV 8, G 8, Dh 128: two
# head groups a kv head), each also with every unit over the most ranks of
# a cluster (8)
SERVED_DECODE = ((0, 1, 256, 1024, 77, 576, 767, 16), (640, 128, 0, 511, 257, 1000, 17, 33))


def sweep_decode_served(ops, dtype, page=16, nb=64) -> dict:
    """Max abs error of B1 against its plain version on SERVED_DECODE, with
    the planned ranks and with the most, each call on its route."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    errs = {}
    for KV, G, Dh in ((16, 1, 64), (8, 4, 128), (8, 8, 128)):
        err = 0.0
        for lengths in SERVED_DECODE:
            B = len(lengths)
            pages = torch.randperm(B * nb, generator=gen, device=DEVICE).int() + 1
            bt = torch.zeros((B, nb), dtype=torch.int32, device=DEVICE)
            for b, n in enumerate(lengths):
                bt[b, :-(-n // page)] = pages[b * nb:b * nb + -(-n // page)]
            kp = torch.randn((1 + B * nb, page, KV, Dh), generator=gen, device=DEVICE).to(dtype)
            vp = torch.randn((1 + B * nb, page, KV, Dh), generator=gen, device=DEVICE).to(dtype)
            kp[0] = vp[0] = 1e3                  # poisoned null page
            q = torch.randn((B, 1, KV * G, Dh), generator=gen, device=DEVICE).to(dtype)
            len_t = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
            plan = ops.decode_plan
            try:
                for forced in (None, ops.RING_MAX_CLUSTER):
                    if forced:
                        ops.decode_plan = lambda *a: forced  # noqa: E731
                    err = max(err, decode_err(ops, dtype, q, kp, vp, bt, len_t, Dh ** -0.5))
            finally:
                ops.decode_plan = plan
        errs[f"KV={KV} G={G} Dh={Dh}"] = err
    return errs


def sweep(ops, dtype, KV, G, Dh, page=16, nb=64, B=8, C=16, calls_of=None):
    """Max abs error of B1 and B2 against their plain versions; every B1 and
    B2 call must take the route its dtype and width pick. ``calls_of(long
    row's length)`` gives the chunks (``chunk_calls`` at ``C`` unless
    given)."""
    rng = np.random.default_rng(SEED)
    dev = DEVICE
    num_pages, lengths, bt = layout(rng, B, nb, page)
    kp = torch.randn(num_pages, page, KV, Dh, device=dev).to(dtype)
    vp = torch.randn(num_pages, page, KV, Dh, device=dev).to(dtype)
    kp[0] = vp[0] = 1e3                          # poisoned null page
    q = torch.randn(B, 1, KV * G, Dh, device=dev).to(dtype)
    bt_t = torch.tensor(bt, device=dev)
    len_t = torch.tensor(lengths, device=dev)
    scale = Dh ** -0.5
    err_dec = decode_err(ops, dtype, q, kp, vp, bt_t, len_t, scale)
    err_pre = 0.0
    row = bt_t[-1]                               # the long row's pages
    calls = (calls_of or (lambda n: chunk_calls(n, C)))(int(lengths[-1]))
    before = dict(ops.ROUTE_LAUNCHES)
    for offset, valid, c in calls:
        qc = torch.randn(1, c, KV * G, Dh, device=dev).to(dtype)
        o = ops.paged_prefill(qc, kp, vp, row, offset, valid, scale)
        torch.cuda.synchronize()
        r = ops.paged_prefill_plain(qc, kp, vp, row, offset, valid, scale)
        err_pre = max(err_pre, (o[0, :valid].float() - r[0, :valid].float()).abs().max().item())
    route = ops.prefill_route(dtype, Dh, Dh)
    moved = routes_moved(ops.ROUTE_LAUNCHES, before)
    check(moved == {r: len(calls) * (r == route) for r in moved},
          f"paged_prefill {dtype} Dh={Dh}: routes {moved}, want all {route}")
    return err_dec, err_pre


# B2 at the speculative verify chunk's shapes: C = spec_len + 1 query rows
# (2, 5, 9; most of a 16-row tile is padding), valid = C or fewer, at offsets
# 0, 1, 15, 17 and the block ceiling less C (the last chunk a row at the
# ceiling can verify), over a draft's block row: another slot's pages for
# the history, scratch pages from the frontier block on, the first seeded
# with the frontier page's payload as the engine's page copy does
VERIFY_CHUNKS = ((2, 2), (5, 5), (9, 9), (9, 3))   # C, valid


def sweep_verify(ops, dtype, G, page=16, nb=64, Dh=64) -> float:
    """Max abs error of B2 against its plain version at the verify shapes
    (KV = 16 / G kv heads); every call must take the route its dtype
    picks."""
    KV = 16 // G
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    P = 2 * nb + 8
    kp = torch.randn((P, page, KV, Dh), generator=gen, device=DEVICE).to(dtype)
    vp = torch.randn((P, page, KV, Dh), generator=gen, device=DEVICE).to(dtype)
    kp[0] = vp[0] = 1e3                          # poisoned null page
    perm = torch.randperm(P - 1, generator=gen, device=DEVICE).int() + 1
    target = perm[:nb]                           # the other slot's block row
    err, calls, before = 0.0, 0, dict(ops.ROUTE_LAUNCHES)
    for C, valid in VERIFY_CHUNKS:
        for offset in (0, 1, 15, 17, nb * page - C):
            first, last = offset // page, (offset + valid - 1) // page
            scratch = perm[nb:nb + last - first + 1]
            row = target.clone()
            row[first:last + 1] = scratch        # the draft's view of the row
            if offset % page:                    # the partial frontier's payload
                kp[scratch[0]] = kp[target[first]]
                vp[scratch[0]] = vp[target[first]]
            q = torch.randn((1, C, KV * G, Dh), generator=gen, device=DEVICE).to(dtype)
            o = ops.paged_prefill(q, kp, vp, row, offset, valid, Dh ** -0.5)
            torch.cuda.synchronize()
            r = ops.paged_prefill_plain(q, kp, vp, row, offset, valid, Dh ** -0.5)
            err = max(err, (o[0, :valid].float() - r[0, :valid].float()).abs().max().item())
            calls += 1
    route = ops.prefill_route(dtype, Dh, Dh)
    moved = routes_moved(ops.ROUTE_LAUNCHES, before)
    check(moved == {r: calls * (r == route) for r in moved},
          f"paged_prefill verify {dtype} G={G}: routes {moved}, want all {route}")
    return err


def cpq_pool(gen, P, page, KV, D, slots, bits, L=CPQ_LEVELS):
    """A CPQ arena on the card: ``bits``-bit codes, levels in [0, L), and
    per-slot scale/zero tables whose levels span 1.2-3 around 0. The null
    page 0 holds full-range codes and levels outside [0, L)."""
    from repro_torch.serving.paged_cache import PagedCPQTensor

    dev = DEVICE

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    codes = (torch.randint(0, 1 << bits, (P, page, KV, D), generator=gen, device=dev)
             - 128).to(torch.int8)
    codes[0] = torch.randint(-128, 128, (page, KV, D), generator=gen, device=dev).to(torch.int8)
    level = torch.randint(0, L, (P, page, KV), generator=gen, device=dev).to(torch.int32)
    level[0] = torch.where(rand(page, KV) < 0.5, L + 3, -2).to(torch.int32)
    width = 1.2 + 1.8 * rand(slots, L, KV, D)
    scale = width / ((1 << bits) - 2)
    zero = -width / 2 + 0.1 * torch.randn((slots, L, KV, D), generator=gen, device=dev)
    return PagedCPQTensor(codes, level, scale, zero,
                          torch.ones((slots, KV), dtype=torch.int32, device=dev),
                          torch.zeros((slots, KV, D), device=dev))


def sweep_cpq(cpq_ops, dtype, KV, G, Dh, bits, page=16, nb=64, B=8, C=16, calls_of=None):
    """Max abs error of B5 and B6 against their plain versions. Row 0 is
    empty; row 1 has a live length over an all-null block row (the CPQ arm
    of a tiered decode on a dense-tier row); the last row is long, with a
    partial last page, and serves the prefill chunks (``calls_of`` as in
    ``sweep``)."""
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    num_pages, lengths, bt = layout(rng, B, nb, page)
    bt[1], lengths[1] = 0, 3 * page + 5
    kt = cpq_pool(gen, num_pages, page, KV, Dh, B, bits)
    vt = cpq_pool(gen, num_pages, page, KV, Dh, B, bits)
    q = torch.randn((B, 1, KV * G, Dh), generator=gen, device=DEVICE).to(dtype)
    bt_t = torch.tensor(bt, device=DEVICE)
    len_t = torch.tensor(lengths, device=DEVICE)
    scale = Dh ** -0.5
    before = dict(cpq_ops.DECODE_ROUTE_LAUNCHES)
    out = cpq_ops.paged_cpq_decode(q, kt, vt, bt_t, len_t, scale)
    torch.cuda.synchronize()
    route = cpq_ops.cpq_decode_route(Dh, Dh)
    moved = routes_moved(cpq_ops.DECODE_ROUTE_LAUNCHES, before)
    check(moved == {r: int(r == route) for r in moved},
          f"paged_cpq_decode {dtype} Dh={Dh}: routes {moved}, want {route}")
    ref = cpq_ops.paged_cpq_decode_plain(q, kt, vt, bt_t, len_t, scale)
    err_dec = (out.float() - ref.float()).abs().max().item()
    check(not out[0].any().item(), "paged_cpq_decode: an empty row is not zero")
    err_pre = 0.0
    row, slot = bt_t[-1], B - 1
    calls = (calls_of or (lambda n: chunk_calls(n, C)))(int(lengths[-1]))
    before = dict(cpq_ops.ROUTE_LAUNCHES)
    for offset, valid, c in calls:
        qc, k_raw, v_raw = (torch.randn((1, c, h, Dh), generator=gen, device=DEVICE).to(dtype)
                            for h in (KV * G, KV, KV))
        o = cpq_ops.paged_cpq_prefill(qc, kt, vt, k_raw, v_raw, slot, row, offset, valid, scale)
        torch.cuda.synchronize()
        r = cpq_ops.paged_cpq_prefill_plain(qc, kt, vt, k_raw, v_raw, slot, row, offset,
                                            valid, scale)
        err_pre = max(err_pre, (o[0, :valid].float() - r[0, :valid].float()).abs().max().item())
    route = cpq_ops.cpq_prefill_route(dtype, Dh, Dh, kt.scale.shape[1])
    moved = routes_moved(cpq_ops.ROUTE_LAUNCHES, before)
    check(moved == {r: len(calls) * (r == route) for r in moved},
          f"paged_cpq_prefill {dtype} Dh={Dh}: routes {moved}, want all {route}")
    return err_dec, err_pre


T1_SHAPES = ((16, 1024, 16, 32), (16, 512, 1, 64), (8, 256, 1, 0),  # H, Dm, kv_r, Rr
             # past d_model 2048 (qwen3-4b, phi4-mini, opt-6.7b, jamba): fewer rows a block
             (32, 2560, 8, 32), (24, 3072, 8, 32), (32, 4096, 32, 32), (64, 8192, 8, 64))


def t1_decode_err(t1_ops, dtype, r, qr, xp, krp, bt, lengths, scale) -> float:
    """Max abs error of one B3 call against its plain version; the call must
    take the route its dtype and widths pick, and its empty rows be zero."""
    before = dict(t1_ops.DECODE_ROUTE_LAUNCHES)
    out = t1_ops.paged_decomposed_decode_fwd(r, qr, xp, krp, bt, lengths, scale)
    torch.cuda.synchronize()
    route = t1_ops.t1_decode_route(dtype, r.shape[1], r.shape[2], krp.shape[2], qr.shape[2])
    moved = routes_moved(t1_ops.DECODE_ROUTE_LAUNCHES, before)
    check(moved == {k: int(k == route) for k in moved},
          f"paged_decomposed_decode {dtype} {tuple(r.shape)}: routes {moved}, want {route}")
    ref = t1_ops.paged_decomposed_decode_plain(r, qr, xp, krp, bt, lengths, scale)
    check(not out[lengths == 0].any().item(), "paged_decomposed_decode: an empty row is not zero")
    return (out.float() - ref.float()).abs().max().item()


# B3 at the served T1 shape over the served decode's capacity (8 rows over
# 64 pages of 16): lengths on the tensor-core route's split boundaries, 0
# and the full capacity, each case also with the most splits
# (TOKEN_MAX_SPLITS of 64 keys: many partials merged by the last block of
# each rank)
T1_SERVED_DECODE = ((0, 1024, 576, 77, 300, 129, 64, 1), (640, 128, 0, 511, 257, 1000, 16, 33))


def sweep_t1_served(t1_ops, dtype, H=16, Dm=1024, kv_r=16, Rr=32, page=16, nb=64) -> float:
    """Max abs error of B3 against its plain version on T1_SERVED_DECODE,
    with the planned splits and with the most splits, each call on its
    route."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    err = 0.0
    for lengths in T1_SERVED_DECODE:
        B = len(lengths)
        pages = torch.randperm(B * nb, generator=gen, device=DEVICE).int() + 1
        bt = torch.zeros((B, nb), dtype=torch.int32, device=DEVICE)
        for b, n in enumerate(lengths):
            bt[b, :-(-n // page)] = pages[b * nb:b * nb + -(-n // page)]
        xp = torch.randn((1 + B * nb, page, Dm), generator=gen, device=DEVICE).to(dtype)
        krp = torch.randn((1 + B * nb, page, kv_r, Rr), generator=gen, device=DEVICE).to(dtype)
        xp[0] = krp[0] = 1e3                     # poisoned null page
        r = torch.randn((B, H, Dm), generator=gen, device=DEVICE).to(dtype)
        qr = torch.randn((B, H, Rr), generator=gen, device=DEVICE).to(dtype)
        len_t = torch.tensor(lengths, dtype=torch.int32, device=DEVICE)
        plan, most = t1_ops.t1_decode_plan, t1_ops.TOKEN_MAX_SPLITS
        try:
            for forced in (None, (most, -(-nb * page // most))):
                if forced:
                    t1_ops.t1_decode_plan = lambda *a: forced  # noqa: E731
                err = max(err, t1_decode_err(t1_ops, dtype, r, qr, xp, krp, bt, len_t,
                                             (Dm + Rr) ** -0.5))
        finally:
            t1_ops.t1_decode_plan = plan
    return err


def sweep_t1(t1_ops, dtype, H, Dm, kv_r, Rr, page=16, nb=64, B=8, C=16):
    """Max abs error of B3 and B4 against their plain versions on the layout
    of ``sweep``: an empty row, ragged rows, a long row with a partial last
    page serving the prefill chunks of ``chunk_calls`` (at qwen1.5-0.5b's
    widths the served chunks: a first chunk, valid < C, a mid-page offset,
    past 512 keys, chunks of 8), a poisoned null page. Every B4 call must
    take the route its dtype and widths pick."""
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    num_pages, lengths, bt = layout(rng, B, nb, page)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(dtype)

    xp, krp = randn(num_pages, page, Dm), randn(num_pages, page, kv_r, Rr)
    xp[0] = krp[0] = 1e3                         # poisoned null page
    bt_t = torch.tensor(bt, device=DEVICE)
    len_t = torch.tensor(lengths, device=DEVICE)
    scale = (Dm + Rr) ** -0.5
    r, qr = randn(B, H, Dm), randn(B, H, Rr)
    err_dec = t1_decode_err(t1_ops, dtype, r, qr, xp, krp, bt_t, len_t, scale)
    err_pre = 0.0
    row = bt_t[-1]
    calls = chunk_calls(int(lengths[-1]), C)
    before = dict(t1_ops.ROUTE_LAUNCHES)
    for offset, valid, c in calls:
        rc, qc = randn(c, H, Dm), randn(c, H, Rr)
        o = t1_ops.paged_decomposed_prefill_fwd(rc, qc, xp, krp, row, offset, valid, scale)
        torch.cuda.synchronize()
        ref = t1_ops.paged_decomposed_prefill_plain(rc, qc, xp, krp, row, offset, valid,
                                                    scale)
        err_pre = max(err_pre, (o[:valid].float() - ref[:valid].float()).abs().max().item())
    route = t1_ops.t1_prefill_route(dtype, Dm, Rr)
    moved = routes_moved(t1_ops.ROUTE_LAUNCHES, before)
    check(moved == {r: len(calls) * (r == route) for r in moved},
          f"paged_decomposed_prefill {dtype} Dm={Dm} Rr={Rr}: routes {moved}, want all {route}")
    return err_dec, err_pre


T3_SHAPES = ((16, 1, 64), (8, 4, 128), (8, 3, 128), (32, 1, 64))   # KV, G, Dp (G = 3:
# phi4-mini; KV 32: musicgen)
T3_REL = 1e-5           # B7 vs plain: max abs error <= T3_REL * max |score|


def t3_err(got, want) -> tuple[float, float]:
    """(max abs error over live scores, its bound T3_REL * max |score|); the
    masked scores must be exactly -1e30."""
    live = want > -1e29
    check(torch.equal(got[~live], want[~live]), "proxy scores: a masked score is not -1e30")
    if not live.any():
        return 0.0, 0.0
    return ((got[live] - want[live]).abs().max().item(),
            T3_REL * want[live].abs().max().item())


def sweep_t3(t3_ops, KV, G, Dp, page=16, nb=64, B=8, N=1000):
    """Max abs error of B7 against its plain version, each case checked
    against its own tolerance (T3_REL x its max |score|): the served call
    (the query factors formed in the kernel from q in float32 and bf16,
    rows at the stride of a wider query, its scale given or not, n at and
    short of the capacity) over code pages on the layout of ``sweep`` (an
    empty row, ragged rows, a long row with a partial last page, a poisoned
    null page), then in the contiguous form at N = 1000 (not a multiple of
    the kernel's 128-key blocks) with the factors given at lengths 777 and 0, and
    formed from a bf16 query (the static T3 decode's ``proxy_scores_q``)."""
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    num_pages, lengths, bt = layout(rng, B, nb, page)
    codes = torch.randint(-128, 128, (num_pages, page, KV, Dp), generator=gen,
                          device=DEVICE).to(torch.int8)
    codes[0] = 127                               # poisoned null page
    scale = 0.005 + 0.025 * torch.rand((B, KV, Dp), generator=gen, device=DEVICE)
    zero = -1.5 + 0.3 * torch.randn((B, KV, Dp), generator=gen, device=DEVICE)
    q = torch.randn((B, KV * G, Dp), generator=gen, device=DEVICE) * Dp ** -0.5
    bt_t = torch.tensor(bt, device=DEVICE)
    len_t = torch.tensor(lengths, device=DEVICE)
    errs = []
    # the served call: the query as rows of a (B, 1, H, 2 Dp) tensor in q's
    # type, its scale given (float32 and bf16), and n short of the capacity
    wide = torch.cat([q, q.flip(-1)], -1)[:, None]
    for qdt, q_scale, n in ((torch.float32, None, nb * page), (torch.bfloat16, 0.125, nb * page),
                            (torch.float32, 0.125, nb * page - 37)):
        qv = wide.to(qdt)[:, 0, :, :Dp]
        out = t3_ops.paged_proxy_scores(qv, scale, zero, codes, bt_t, len_t, n, q_scale=q_scale)
        torch.cuda.synchronize()
        q_eff = qv if q_scale is None else qv * q_scale
        errs.append(t3_err(out, t3_ops.paged_proxy_scores_plain(q_eff, scale, zero, codes,
                                                               bt_t, len_t, n)))
        check(bool((out[0] == -1e30).all().item()), "paged_proxy_scores: an empty row is live")
    cont = torch.randint(-128, 128, (B, N, KV, Dp), generator=gen, device=DEVICE).to(torch.int8)
    qs = 0.02 * torch.randn((B, KV, G, Dp), generator=gen, device=DEVICE)
    qz = torch.randn((B, KV, G, 1), generator=gen, device=DEVICE)
    for length in (777, 0):
        o = t3_ops.proxy_scores(qs, qz, cont, length)
        torch.cuda.synchronize()
        errs.append(t3_err(o, t3_ops.proxy_scores_plain(qs, qz, cont, length)))
    # the static T3 decode's form: the factors formed over contiguous codes
    fq = torch.randn((B, KV * G, Dp), generator=gen, device=DEVICE).bfloat16()
    o = t3_ops.proxy_scores_q(fq, scale, zero, cont, torch.tensor(777, dtype=torch.int32))
    torch.cuda.synchronize()
    fs, fz = t3_ops.query_factors(fq, scale, zero)
    errs.append(t3_err(o, t3_ops.proxy_scores_plain(fs, fz, cont, 777).reshape(o.shape)))
    for err, tol in errs:
        check(err <= tol, f"proxy scores KV={KV} G={G} Dp={Dp}: error {err} > {tol}")
    return max(e for e, _ in errs)


FLASH_SWEEP = (  # B, T, S, H, KV, D, causal, arena (k and v: the first S keys)
    (2, 128, 128, 4, 2, 64, True, 128),      # the five cases of tests/test_kernels.py
    (2, 256, 256, 8, 8, 128, True, 256),
    (2, 100, 100, 4, 1, 32, False, 100),
    (2, 192, 192, 6, 3, 64, True, 192),
    (2, 128, 128, 4, 4, 64, True, 128),
    (8, 512, 512, 16, 16, 64, True, 512),    # qwen1.5-0.5b's static prefill
    (8, 1, 575, 16, 16, 64, False, 576),     # its last static dense decode
    (3, 77, 77, 4, 2, 64, True, 77),         # T and S no block multiple
    (1, 512, 512, 16, 16, 64, True, 512),    # a one-shot admission's prompt
    (1, 512, 512, 64, 8, 128, True, 512),    # serve (o), jamba: 64 heads over 8, Dh 128: a
    (8, 512, 512, 64, 8, 128, True, 512),    # one-shot admission's prompt, the static
    (8, 1, 575, 64, 8, 128, False, 576),     # prefill and the last static decode
    (8, 512, 1600, 32, 8, 128, False, 1600),  # serve (p), llama-vision's cross-attention:
    (1, 77, 1600, 32, 8, 128, False, 1600),  # the static prompts over 1600 patch keys (T < S),
    (8, 1, 1600, 32, 8, 128, False, 1600),   # a short one, and a decode token over them
    (8, 512, 512, 32, 32, 64, True, 512),    # serve (q), musicgen: its static prefill and
    (8, 1, 575, 32, 32, 64, False, 576),     # its last static decode
) + tuple(  # every head width and group size of the routes, a prompt (causal and not,
    # T no multiple of the 64-row tile, k and v a prefix) and a decode token
    case for D in (32, 64, 128, 256) for G in (1, 4, 8)
    for case in ((2, 200, 200, 2 * G, 2, D, True, 208), (2, 200, 200, 2 * G, 2, D, False, 200),
                 (3, 1, 300, 2 * G, 2, D, False, 301)))

T1C_SWEEP = (  # B, N, H, Dm, kv_r, Rr, length
    (8, 576, 16, 1024, 16, 32, 575),         # qwen1.5-0.5b's static T1 decode
    (4, 300, 16, 512, 1, 64, 300),           # MLA-like: one shared roped key
    (4, 200, 8, 256, 1, 0, 150),             # no roped term, length < N
    (3, 77, 16, 1024, 16, 32, 77),           # N no multiple of the 16-key split
    (4, 300, 32, 2560, 8, 32, 299),          # past d_model 2048: qwen3-4b
    (2, 100, 24, 3072, 8, 32, 77),           # phi4-mini
    (2, 64, 32, 4096, 1, 64, 64),            # opt-6.7b / llama-vision widths
    (2, 50, 64, 8192, 8, 64, 33),            # jamba
    (2, 300, 16, 1024, 16, 32, 290),         # qwen's widths past one key split
    (2, 300, 32, 512, 8, 16, 257),           # 32 heads: two head tiles
    (2, 40, 16, 1024, 16, 32, 0),            # length 0: zeros
    (8, 576, 16, 512, 1, 64, 575),           # deepseek-v2-lite's static MLA decode
    (8, 576, 16, 512, 1, 64, 193),           # ... past one key split, length < N
    (2, 40, 16, 512, 1, 64, 0),              # ... length 0
    (8, 576, 32, 2048, 32, 0, 575),          # musicgen's static T1 decode (the sweep)
)
CPQC_SWEEP = (  # B, N, KV, G, Dh, bits, length
    (8, 576, 16, 1, 64, 4, 575),             # qwen1.5-0.5b's static T2 decode
    (4, 300, 4, 4, 128, 8, 250),             # G = 4, length < N
    (2, 77, 16, 1, 64, 8, 77),               # N no multiple of a split
    (2, 90, 1, 8, 256, 4, 77),               # gemma-2b: 8 heads over one kv head, Dh 256
    (8, 576, 32, 1, 64, 4, 575),             # musicgen's static T2 decode (MHA, 32 heads)
)


# B8 at MLA's prompt shapes (deepseek-v2-lite: 16 heads of Dh 192 = nope 128 +
# rope 64 and Dv 128, every head its own K/V): one-shot admissions of 64-512
# tokens, the static batch of 8 x 512, T no multiple of a tile, k and v a prefix
MLA_FLASH_SWEEP = (  # B, T, S, H, KV, Dh, Dv, causal, arena
    (1, 512, 512, 16, 16, 192, 128, True, 512), (1, 64, 64, 16, 16, 192, 128, True, 64),
    (8, 512, 512, 16, 16, 192, 128, True, 512), (3, 77, 77, 16, 16, 192, 128, True, 77),
    (2, 200, 200, 16, 16, 192, 128, True, 208), (2, 200, 200, 16, 16, 192, 128, False, 200))


def exact_attention(q, k, v, scale: float, causal: bool) -> torch.Tensor:
    """Attention worked wholly in float64 from the given inputs, H / KV
    query heads sharing each k and v head: what B8's bf16 cases are held
    against."""
    g = q.shape[2] // k.shape[2]
    k, v = (t.double().repeat_interleave(g, dim=2) for t in (k, v))
    s = torch.einsum("bthd,bshd->bhts", q.double(), k) * scale
    if causal:  # query i sees keys 0..i
        s = s.masked_fill(torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).triu(1),
                          float("-inf"))
    return torch.einsum("bhts,bshd->bthd", s.softmax(-1), v)


def sweep_flash(fa_ops, dtype, cases=None, exact: dict | None = None) -> dict:
    """Max abs error of B8 per FLASH_SWEEP case (or per ``cases`` of
    MLA_FLASH_SWEEP's form, Dh and Dv apart): in float32 against its plain
    version; in bf16 against ``exact_attention`` on the same bf16 inputs,
    and no farther from it than the plain version (which rounds the
    normalised weights to bf16, where the kernel rounds the unnormalised
    ones, whose largest is exactly 1). ``exact`` collects each bf16 case's
    three distances. Every prompt call in bf16 must take the tensor-core
    route."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    cases = cases or [(B, T, S, H, KV, D, D, c, a) for B, T, S, H, KV, D, c, a in FLASH_SWEEP]
    for B, T, S, H, KV, Dh, Dv, causal, arena in cases:
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                   for shape in ((B, T, H, Dh), (B, arena, KV, Dh), (B, arena, KV, Dv)))
        k, v = k[:, :S], v[:, :S]
        before = dict(fa_ops.ROUTE_LAUNCHES)
        got = fa_ops.flash_attention(q, k, v, Dh ** -0.5, causal)
        torch.cuda.synchronize()
        route = "decode" if T == 1 else "prompt" if dtype == torch.bfloat16 else "prompt_f32"
        moved = routes_moved(fa_ops.ROUTE_LAUNCHES, before)
        width = f"D={Dh}" if Dh == Dv else f"Dh={Dh} Dv={Dv}"
        tag = f"B={B} T={T} S={S} H={H} KV={KV} {width} causal={causal}"
        check(moved == {r: int(r == route) for r in moved},
              f"flash_attention {dtype} {tag}: routes {moved}, want {route}")
        ref = fa_ops.flash_attention_plain(q, k, v, Dh ** -0.5, causal)
        if dtype == torch.float32:
            out[tag] = (got - ref).abs().max().item()
            continue
        oracle = exact_attention(q, k, v, Dh ** -0.5, causal)
        out[tag], plain = ((t.double() - oracle).abs().max().item() for t in (got, ref))
        check(out[tag] <= plain, f"flash_attention {dtype} {tag}: {out[tag]} from exact "
              f"attention, farther than the plain version's {plain}")
        if exact is not None:
            exact[tag] = {"kernel": out[tag], "plain": plain,
                          "kernel_vs_plain": (got.float() - ref.float()).abs().max().item()}
        del oracle
    return out


def sweep_t1c(t1_ops, dtype) -> dict:
    """Max abs error of B9 against its plain version per T1C_SWEEP case; each
    call must take the route its dtype and widths pick, and a length of 0
    give zeros."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    for B, N, H, Dm, kv_r, Rr, length in T1C_SWEEP:
        r, qr, x, kr = (torch.randn(shape, generator=gen, device=DEVICE).to(dtype)
                        for shape in ((B, H, Dm), (B, H, Rr), (B, N, Dm), (B, N, kv_r, Rr)))
        x[:, length:] = 1e3                      # unwritten slots: never read
        scale = (Dm + Rr) ** -0.5
        before = dict(t1_ops.CONTIG_ROUTE_LAUNCHES)
        got = t1_ops.decomposed_decode_fwd(r, qr, x, kr, length, scale)
        torch.cuda.synchronize()
        route = t1_ops.t1_decode_route(dtype, H, Dm, kv_r, Rr)
        moved = routes_moved(t1_ops.CONTIG_ROUTE_LAUNCHES, before)
        tag = f"B={B} N={N} H={H} Dm={Dm} kv_r={kv_r} Rr={Rr} length={length}"
        check(moved == {k: int(k == route) for k in moved},
              f"decomposed_decode {dtype} {tag}: routes {moved}, want {route}")
        check(length > 0 or not got.any().item(), f"decomposed_decode {tag}: not zero")
        ref = t1_ops.decomposed_decode_plain(r, qr, x, kr, length, scale)
        out[tag] = (got.float() - ref.float()).abs().max().item()
    return out


def sweep_cpqc(cpq_ops, dtype) -> dict:
    """Max abs error of B10 (float32 output) against its plain version per
    CPQC_SWEEP case, tiles rounded to bf16 and not; q in ``dtype``. The
    arenas hold pruned codes (-128, which dequantize to 0) and, in row 0,
    levels outside [0, L) (scale = zero = 0)."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = {}
    for B, N, KV, G, Dh, bits, length in CPQC_SWEEP:
        kt = cpq_pool(gen, B, N, KV, Dh, B, bits)   # (B, N, KV, D): one page of N per row
        vt = cpq_pool(gen, B, N, KV, Dh, B, bits)
        check(bool((kt.codes == -128).any().item()), "cpq sweep: no pruned code")
        q = torch.randn((B, KV, G, Dh), generator=gen, device=DEVICE).to(dtype)
        args = (q, kt.codes, vt.codes, kt.scale, kt.zero, vt.scale, vt.zero, kt.level,
                vt.level, length, Dh ** -0.5)
        for rnd in (True, False):
            got = cpq_ops.cpq_decode_fwd(*args, rnd)
            torch.cuda.synchronize()
            ref = cpq_ops.cpq_decode_plain(*args, rnd)
            out[f"B={B} N={N} KV={KV} G={G} Dh={Dh} bits={bits} length={length} "
                f"round={rnd}"] = (got - ref).abs().max().item()
        pruned = cpq_ops.cpq_decode_fwd(*args[:2], torch.full_like(vt.codes, -128),
                                        *args[3:], True)
        check(not pruned.any().item(), "cpq_decode: all-pruned values do not give 0")
    return out


# --------------------------------------------------------- phase 4: serve


class StandIn:
    """Installed under a kernel wrapper's module-level name, passing calls
    on to the wrapper ``fn``. The wrapper counts its launches through that
    name, which is this stand-in while it is installed: keep the count on
    the wrapper."""

    fn = None

    @property
    def launches(self) -> int:
        return self.fn.launches

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches = n


class Recorder(StandIn):
    """Wraps a kernel wrapper: passes every call through, keeps the arenas of
    the first ``n_layers`` calls (one per layer) and a sample of the calls'
    small inputs, so the kernel can be timed later at the served shapes.
    ``split(*args)`` names a call's two arenas; ``snap(*args)`` copies the
    sample."""

    def __init__(self, fn, n_layers: int, every: int, split, snap):
        self.fn, self.n_layers, self.every = fn, n_layers, every
        self.split, self.snap = split, snap
        self.calls, self.arenas, self.samples = 0, [], []

    def __call__(self, *args, **kw):
        if len(self.arenas) < self.n_layers:
            self.arenas.append(self.split(*args))
        if self.calls % (self.n_layers * self.every) == 0:
            # a launch's plan (``whole``) is no input of its kernel's
            self.samples.append(self.snap(*args, **{k: v for k, v in kw.items()
                                                    if k != "whole"}))
        self.calls += 1
        return self.fn(*args, **kw)


def served_config(T):
    """Full-width qwen1.5-0.5b: 24 layers, d_model 1024, vocab 151936."""
    cfg = T.ARCHS["qwen1.5-0.5b"]
    check(cfg.num_layers == 24 and cfg.vocab_size == 151936, "not the full config")
    return cfg


def make_requests(T, vocab: int, seed: int = SEED):
    rng = np.random.default_rng(seed)
    lens = rng.integers(64, 513, size=8)
    lens[0], lens[1] = 64, 512
    return [T.Request(rid=i, prompt=rng.integers(0, vocab, size=int(n)).astype(np.int32),
                      max_new_tokens=64) for i, n in enumerate(lens)]


def serve_timed(eng, T, reqs):
    """Drive the engine tick by tick, a device sync around each tick.
    Returns (results, stats, ticks, wall s); a tick is (ms, rows decoded,
    prefilled a prompt chunk or a one-shot admission, ran the decode step)."""
    eng.reset(T.GenerationConfig())
    for r in reqs:
        eng.add_request(r)
    ticks = []
    t_all = time.perf_counter()
    while eng.has_unfinished():
        before = eng.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = eng.stats()
        rows = after["generated_tokens"] - before["generated_tokens"]
        chunk = after["prefill_tokens"] > before["prefill_tokens"]  # a chunk or an admission
        decoded = after["decode_steps"] > before["decode_steps"]
        ticks.append((ms, rows if decoded else 0, chunk, decoded))
    wall = time.perf_counter() - t_all
    return eng.results(), eng.stats(), ticks, wall


def decode_bound(q, bt, lengths, Dh, Dv, KV, elt):
    """(bytes, flops) one B1 call needs: the live K/V, q and out once each,
    the block table and lengths."""
    live = lengths.long().sum().item()
    nbytes = (live * KV * (Dh + Dv) * elt + q.numel() * elt * (1 + Dv / Dh)
              + bt.numel() * 4 + lengths.numel() * 4)
    flops = 2.0 * live * q.shape[2] * (Dh + Dv)
    return nbytes, flops


def prefill_bound(q, offset, valid, Dh, Dv, KV, elt, page):
    """(bytes, flops) one B2 call needs: the slot's live K/V, q and out
    once each, the mapped block-table entries; flops of the valid rows."""
    H = q.shape[2]
    live = offset + valid
    pairs = sum(offset + i + 1 for i in range(valid))
    nbytes = (live * KV * (Dh + Dv) * elt + q.numel() * elt * (1 + Dv / Dh)
              + -(-live // page) * 4)
    flops = 2.0 * pairs * H * (Dh + Dv)
    return nbytes, flops


def cpq_decode_bound(q, bt, lengths, kt, vt):
    """(bytes, flops, float32 flops) one B5 call needs: the live codes and
    levels, the scale/zero tables of every row with a live key (a row of
    length 0 reads none), q and out once each, the block table and lengths;
    the attention's flops in q's type and the dequantization's float32
    multiply-adds."""
    live = lengths.long().sum().item()
    KV, Dh, Dv = kt.codes.shape[2], kt.codes.shape[3], vt.codes.shape[3]
    elt = q.element_size()
    live_rows = int((lengths > 0).sum().item())
    tables = 2 * 4 * (kt.scale[0].numel() + vt.scale[0].numel()) * live_rows
    nbytes = (live * KV * (Dh + Dv + 2 * 4) + tables + q.numel() * elt * (1 + Dv / Dh)
              + bt.numel() * 4 + lengths.numel() * 4)
    return nbytes, 2.0 * live * q.shape[2] * (Dh + Dv), 2.0 * live * KV * (Dh + Dv)


def cpq_prefill_bound(q, k_raw, offset, valid, kt, vt):
    """(bytes, flops, float32 flops) one B6 call needs: the slot's codes and
    levels before ``offset``, its tables (none at offset 0, where only the
    raw tail is attended), the chunk's raw K/V, q and out once each, the
    mapped block-table entries."""
    KV, Dh, Dv, page = kt.codes.shape[2], kt.codes.shape[3], vt.codes.shape[3], kt.codes.shape[1]
    H, elt = q.shape[2], q.element_size()
    pairs = valid * offset + sum(i + 1 for i in range(valid))
    tables = 2 * 4 * (kt.scale[0].numel() + vt.scale[0].numel()) if offset > 0 else 0
    nbytes = (offset * KV * (Dh + Dv + 2 * 4) + tables
              + k_raw.numel() * elt * (1 + Dv / Dh) + q.numel() * elt * (1 + Dv / Dh)
              + -(-offset // page) * 4)
    return nbytes, 2.0 * pairs * H * (Dh + Dv), 2.0 * offset * KV * (Dh + Dv)


def t1_decode_bound(r, qr, bt, lengths, x0, kr0):
    """(bytes, flops) one B3 call needs: the live X rows and roped keys, R
    and q_rope of the rows with a live key (a row of length 0 reads none),
    P of every row once, the block table and lengths; two products of width
    Dm and the roped one per live key and head."""
    live = lengths.long().sum().item()
    live_rows = int((lengths > 0).sum().item())
    H, Dm, Rr, elt = r.shape[1], r.shape[2], qr.shape[-1], x0.element_size()
    nbytes = (live * (Dm + kr0.shape[2] * kr0.shape[3]) * elt
              + (live_rows * H * (Dm + Rr) + r.numel()) * elt
              + bt.numel() * 4 + lengths.numel() * 4)
    return nbytes, 2.0 * live * H * (2 * Dm + Rr)


def t1_prefill_bound(r, qr, offset, valid, x0, kr0):
    """(bytes, flops) one B4 call needs: the slot's live X rows and roped
    keys, R, q_rope and P of the ``valid`` chunk rows once each (the padding
    rows' P is never read), the mapped block-table entries; flops of the
    valid rows under the causal mask."""
    C, H, Dm = r.shape
    Rr, elt, page = qr.shape[-1], x0.element_size(), x0.shape[1]
    live = offset + valid
    pairs = sum(offset + i + 1 for i in range(valid))
    nbytes = (live * (Dm + kr0.shape[2] * kr0.shape[3]) * elt
              + valid * H * (2 * Dm + Rr) * elt + -(-live // page) * 4)
    return nbytes, 2.0 * pairs * H * (2 * Dm + Rr)


def t3_bound(q, tables, bt, lengths, n, codes0):
    """(bytes, flops, float32 flops) one B7 call needs: the live codes (up
    to n per row), q, every row's proxy scale and zero tables, the scores
    written, the block table and lengths; one float32 multiply-add per live
    code and query head."""
    live = lengths.long().clamp(max=n).sum().item()
    B, H = q.shape[:2]
    KV, Dp = codes0.shape[2], codes0.shape[3]
    nbytes = (live * KV * Dp + q.numel() * q.element_size() + 2 * tables[0].numel() * 4
              + B * H * n * 4 + bt.numel() * 4 + lengths.numel() * 4)
    return nbytes, 0.0, 2.0 * live * H * Dp


def bound_of(nbytes, flops, dtype, f32_flops=0.0):
    """The least time of a call: its bytes over the memory rate, or its
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / (BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS)
             + f32_flops / F32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def graph_ms(fn, reps: int = 10) -> float:
    """Device time of one ``fn()``: replays of a CUDA graph that captured it,
    so host launch overhead stays out of the measurement."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, reps)


def time_kernel(rec, make) -> dict:
    """Mean per-launch times of one kernel over the calls sampled from the
    served run. Each sampled call is replayed over every layer's arena in
    turn, as the model runs it (the next layer's pages are cold in L2):
    ``ms`` from a CUDA graph of those launches (device time), ``eager_ms``
    launched from Python as the engine does (host launch cost included).
    ``make(sample, k0, v0)`` returns (kernel(k, v), plain(), library(),
    (bytes, flops)) for one sample; plain and library run on layer 0."""
    rows = []
    for sample in rec.samples:
        kern, plain, lib, need = make(sample, *rec.arenas[0])

        def layers():
            for k, v in rec.arenas:
                kern(k, v)

        n = len(rec.arenas)
        rows.append((graph_ms(layers) / n, cuda_ms(layers, 3) / n, graph_ms(plain),
                     graph_ms(lib)) + bound_of(need[0], need[1], sample[0].dtype, *need[2:]))
    ms, eager, plain, lib, bound, kinds = zip(*rows)
    return dict(ms=float(np.mean(ms)), eager_ms=float(np.mean(eager)),
                plain_ms=float(np.mean(plain)), library_ms=float(np.mean(lib)),
                bound_ms=float(np.mean(bound)),
                bound_by="bytes" if set(kinds) == {"bytes"} else "operations",
                samples=len(rows))


def decode_case(ops, scale):
    """B1 at one sampled decode call; the yardstick is
    scaled_dot_product_attention on the gathered K/V under a length mask."""
    from repro_torch.serving.paged_cache import gather_pages

    def make(sample, k0, v0):
        q, bt, lengths = sample
        KV, Dh, Dv, H = k0.shape[2], k0.shape[3], v0.shape[3], q.shape[2]
        kg = gather_pages(k0, bt).transpose(1, 2)           # (B, KV, N, Dh)
        vg = gather_pages(v0, bt).transpose(1, 2)
        mask = (torch.arange(kg.shape[2], device=q.device)[None, :]
                < lengths[:, None])[:, None, None, :]
        qq = q.transpose(1, 2)
        gqa = {"enable_gqa": True} if H != KV else {}
        return (lambda k, v: ops.paged_decode(q, k, v, bt, lengths, scale),
                lambda: ops.paged_decode_plain(q, k0, v0, bt, lengths, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kg, vg, attn_mask=mask, scale=scale, **gqa),
                decode_bound(q, bt, lengths, Dh, Dv, KV, q.element_size()))
    return make


def prefill_case(ops, scale):
    """B2 at one sampled chunk call; the yardstick is
    scaled_dot_product_attention on the slot's gathered K/V, causal mask."""
    from repro_torch.serving.paged_cache import gather_pages

    def make(sample, k0, v0):
        q, row, offset, valid = sample
        KV, Dh, Dv, C, H = k0.shape[2], k0.shape[3], v0.shape[3], q.shape[1], q.shape[2]
        n = offset + valid
        kg = gather_pages(k0, row[None])[:, :n].transpose(1, 2)   # (1, KV, n, Dh)
        vg = gather_pages(v0, row[None])[:, :n].transpose(1, 2)
        pos = torch.arange(n, device=q.device)
        mask = (pos[None, :] <= offset + torch.arange(C, device=q.device)[:, None])
        qq = q.transpose(1, 2)
        gqa = {"enable_gqa": True} if H != KV else {}
        return (lambda k, v: ops.paged_prefill(q, k, v, row, offset, valid, scale),
                lambda: ops.paged_prefill_plain(q, k0, v0, row, offset, valid, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kg, vg, attn_mask=mask[None, None], scale=scale, **gqa),
                prefill_bound(q, offset, valid, Dh, Dv, KV, q.element_size(),
                              k0.shape[1]))
    return make


def cpq_decode_case(cpq_ops, scale):
    """B5 at one sampled decode call; the yardstick is
    scaled_dot_product_attention over K/V dequantized and gathered
    beforehand, under a length mask."""
    from repro_torch.core.cpq import cpq_dequant
    from repro_torch.serving.paged_cache import logical_cpq

    def make(sample, k0, v0):
        q, bt, lengths = sample
        H, KV = q.shape[2], k0.codes.shape[2]
        kg = cpq_dequant(logical_cpq(k0, bt), q.dtype).transpose(1, 2)   # (B, KV, N, Dh)
        vg = cpq_dequant(logical_cpq(v0, bt), q.dtype).transpose(1, 2)
        mask = (torch.arange(kg.shape[2], device=q.device)[None, :]
                < lengths[:, None])[:, None, None, :]
        qq = q.transpose(1, 2)
        gqa = {"enable_gqa": True} if H != KV else {}
        return (lambda k, v: cpq_ops.paged_cpq_decode(q, k, v, bt, lengths, scale),
                lambda: cpq_ops.paged_cpq_decode_plain(q, k0, v0, bt, lengths, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kg, vg, attn_mask=mask, scale=scale, **gqa),
                cpq_decode_bound(q, bt, lengths, k0, v0))
    return make


def cpq_prefill_case(cpq_ops, scale):
    """B6 at one sampled chunk call; the yardstick is
    scaled_dot_product_attention over the slot's earlier tokens,
    dequantized and gathered beforehand, and the chunk's raw K/V, with the
    chunk's causal mask."""
    from repro_torch.core.cpq import cpq_dequant
    from repro_torch.serving.paged_cache import _slot_cpq

    def make(sample, k0, v0):
        q, k_raw, v_raw, slot, row, offset, valid = sample
        H, KV, C = q.shape[2], k0.codes.shape[2], q.shape[1]
        kg = torch.cat([cpq_dequant(_slot_cpq(k0, row, slot), q.dtype)[:, :offset], k_raw], 1)
        vg = torch.cat([cpq_dequant(_slot_cpq(v0, row, slot), q.dtype)[:, :offset], v_raw], 1)
        col = torch.arange(offset + C, device=q.device)[None, :] - offset
        tok = torch.arange(C, device=q.device)[:, None]
        mask = (col < 0) | ((col < valid) & (col <= tok))
        qq = q.transpose(1, 2)
        gqa = {"enable_gqa": True} if H != KV else {}
        return (lambda k, v: cpq_ops.paged_cpq_prefill(q, k, v, k_raw, v_raw, slot, row,
                                                       offset, valid, scale),
                lambda: cpq_ops.paged_cpq_prefill_plain(q, k0, v0, k_raw, v_raw, slot, row,
                                                        offset, valid, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kg.transpose(1, 2), vg.transpose(1, 2), attn_mask=mask[None, None],
                    scale=scale, **gqa),
                cpq_prefill_bound(q, k_raw, offset, valid, k0, v0))
    return make


def _t1_sdpa_operands(r, qr, xg, krg):
    """The yardstick's operands for T1: q = [R | q_rope], k = [X | the head's
    roped key], v = X, heads laid out (N, H, keys, width); xg (N, n, Dm) and
    krg (N, n, kv_r, Rr) are gathered beforehand."""
    N, H, n = r.shape[0], r.shape[-2], xg.shape[1]
    k_rope = krg.repeat_interleave(H // krg.shape[2], dim=2).transpose(1, 2)  # (N, H, n, Rr)
    x = xg[:, None].expand(N, H, n, xg.shape[2])
    return (torch.cat([r, qr], -1).transpose(-3, -2),
            torch.cat([x, k_rope], -1).contiguous(), x.contiguous())


def t1_decode_case(t1_ops, scale):
    """B3 at one sampled decode call (the sweep: R and P W_V are einsums
    outside it); the yardstick is scaled_dot_product_attention with
    q = [R | q_rope], k = [X | roped key of the head] and v = X gathered
    beforehand, under a length mask: the same function."""
    from repro_torch.serving.paged_cache import gather_pages

    def make(sample, x0, kr0):
        r, qr, bt, lengths = sample
        qq, kk, vv = _t1_sdpa_operands(r[:, None], qr[:, None], gather_pages(x0, bt),
                                       gather_pages(kr0, bt))
        mask = (torch.arange(kk.shape[2], device=r.device)[None, :]
                < lengths[:, None])[:, None, None, :]
        return (lambda x, kr: t1_ops.paged_decomposed_decode_fwd(r, qr, x, kr, bt, lengths,
                                                                 scale),
                lambda: t1_ops.paged_decomposed_decode_plain(r, qr, x0, kr0, bt, lengths,
                                                             scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask, scale=scale),
                t1_decode_bound(r, qr, bt, lengths, x0, kr0))
    return make


def t1_prefill_case(t1_ops, scale):
    """B4 at one sampled chunk call; the yardstick is
    scaled_dot_product_attention on the slot's gathered [X | roped key] and
    X with the chunk's causal mask."""
    from repro_torch.serving.paged_cache import gather_pages

    def make(sample, x0, kr0):
        r, qr, row, offset, valid = sample
        C, n = r.shape[0], offset + valid
        qq, kk, vv = _t1_sdpa_operands(r[None], qr[None], gather_pages(x0, row[None])[:, :n],
                                       gather_pages(kr0, row[None])[:, :n])
        pos = torch.arange(n, device=r.device)
        mask = pos[None, :] <= offset + torch.arange(C, device=r.device)[:, None]
        return (lambda x, kr: t1_ops.paged_decomposed_prefill_fwd(r, qr, x, kr, row, offset,
                                                                  valid, scale),
                lambda: t1_ops.paged_decomposed_prefill_plain(r, qr, x0, kr0, row, offset,
                                                              valid, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qq, kk, vv, attn_mask=mask[None, None], scale=scale),
                t1_prefill_bound(r, qr, offset, valid, x0, kr0))
    return make


def t3_decode_case(t3_ops):
    """B7 at one sampled decode call (the served ``paged_proxy_scores``: one
    launch that forms the query factors from the query slice and its scale,
    then scores); the yardstick is torch.matmul of the query factors,
    formed beforehand, against the rows' codes gathered, shifted by 128 and
    converted to float32 beforehand, plus qz: the same scores, unmasked."""
    from repro_torch.serving.paged_cache import gather_pages

    def make(sample, codes0, tables0):
        q, bt, lengths, n, q_scale = sample
        q_eff = q if q_scale is None else q * q_scale
        qs, qz = t3_ops.query_factors(q_eff, *tables0)
        cg = (gather_pages(codes0, bt)[:, :n].float() + 128.0).permute(0, 2, 3, 1).contiguous()
        return (lambda codes, tables: t3_ops.paged_proxy_scores(q, *tables, codes, bt,
                                                                 lengths, n, q_scale=q_scale),
                lambda: t3_ops.paged_proxy_scores_plain(q_eff, *tables0, codes0, bt, lengths,
                                                        n),
                lambda: torch.matmul(qs, cg) + qz,
                t3_bound(q, tables0, bt, lengths, n, codes0))
    return make


def profile_windows(make_engine, T, reqs, ticks, windows) -> list[dict]:
    """Replays the same serve (greedy, so tick i does the same work) and
    profiles the given tick windows with torch.profiler: device time by
    kernel, and the device's busy share of those ticks' unprofiled wall
    time (taken from ``ticks`` of the measured run). Only the CUDA activity
    is traced: the host's operator events change no device time and took
    half of each replay's seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = make_engine()
    eng.reset(T.GenerationConfig())
    for r in reqs:
        eng.add_request(r)
    done = 0

    def run_to(n):
        nonlocal done
        while done < n and eng.has_unfinished():
            eng.step()
            done += 1

    out = []
    for lo, hi in windows:
        run_to(lo)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run_to(hi)
            torch.cuda.synchronize()
        kernels = sorted(((e.key, e.device_time_total / 1e3, e.count)
                          for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
                         key=lambda r: -r[1])
        busy = sum(ms for _, ms, _ in kernels)
        wall = sum(t[0] for t in ticks[lo:hi])
        attn = sum(ms for k, ms, _ in kernels if any(a in k for a in ATTENTION_KERNELS))
        gemm = sum(ms for k, ms, _ in kernels if any(g in k for g in ("gemm", "nvjet", "cutlass", "xmma")))
        out.append({"ticks": [lo, hi], "decode_only_ticks": sum(1 for t in ticks[lo:hi] if not t[2]),
                    "device_busy_ms": busy, "unprofiled_wall_ms": wall,
                    "busy_share": busy / wall, "attn_ms": attn, "gemm_ms": gemm,
                    "top_kernels": [{"name": k, "ms": ms, "count": n}
                                    for k, ms, n in kernels[:12]]})
    return out


def log_profile(what: str, prof: list[dict]) -> None:
    for w in prof:
        n = w["ticks"][1] - w["ticks"][0]
        log(f"profile {what} ticks {w['ticks']} ({w['decode_only_ticks']} decode-only): "
            f"device busy {w['device_busy_ms']:.2f} ms of {w['unprofiled_wall_ms']:.2f} ms "
            f"wall = {w['busy_share']:.1%}; {w['device_busy_ms'] / n:.3f} ms device and "
            f"{w['unprofiled_wall_ms'] / n:.3f} ms wall per tick; attention kernels "
            f"{w['attn_ms']:.2f} ms, GEMMs {w['gemm_ms']:.2f} ms")
        for k in w["top_kernels"][:6]:
            log(f"profile:   {k['ms']:8.3f} ms {k['count']:5d}x {k['name'][:100]}")


def zero_routes(routed: dict) -> None:
    for counter, _ in routed.values():
        for r in counter:
            counter[r] = 0


def check_routes(what: str, routed: dict, counts: dict) -> dict:
    """Every launch of a kernel with two routes took the route a bf16 serve
    gives it (B2, B3, B4, B6 and B9 the tensor cores, B5 the single-query
    decode, B1 the ring):
    each route counter against the wrapper's launches. Returns the route
    counts by kernel."""
    routes = {name: dict(counter) for name, (counter, _) in routed.items()}
    for name, got in routes.items():
        n, served = counts.get(name, 0), routed[name][1]
        check(got == {r: n * (r == served) for r in got},
              f"{what}: {name} routes {got} for {n} launches, want all {served}")
    return routes


def mid_decode_window(ticks) -> tuple[int, int]:
    """10 ticks around the middle decode-only tick of a served run."""
    pure = [i for i, t in enumerate(ticks) if t[3] and not t[2]]
    return pure[len(pure) // 2 - 5], pure[len(pure) // 2 + 5]


# ------------------------------------------ phase 4: the contiguous path


def static_prompts(vocab: int) -> dict:
    """The static serve's batch: 8 prompts of 512 seeded tokens."""
    rng = np.random.default_rng(SEED + 1)
    return {"tokens": rng.integers(0, vocab, size=(8, 512)).astype(np.int32)}


def arena_of(t: torch.Tensor) -> torch.Tensor:
    """The whole (B, N, KV, D) arena that a (B, S, KV, D) prefix view lies in."""
    B, _, KV, D = t.shape
    return torch.as_strided(t, (B, t.stride(0) // (KV * D), KV, D), t.stride())


class FlashRecorder(StandIn):
    """B8's Recorder: its prompt calls (T > 1, causal over fresh K/V) and its
    decode calls (one query token over the written prefix of the static
    dense arena) are sampled apart. A decode sample keeps the prefix length;
    its arena is the layer's whole arena."""

    def __init__(self, fn, n_layers: int):
        self.fn = fn
        self.pre = Recorder(fn, n_layers, 1, lambda q, k, v, *r: (k, v),
                            lambda q, k, v, *r: (q.clone(),))
        self.dec = Recorder(fn, n_layers, 10, lambda q, k, v, *r: (arena_of(k), arena_of(v)),
                            lambda q, k, v, *r: (q.clone(), k.shape[1]))

    def __call__(self, q, k, v, scale, causal=True):
        return (self.pre if q.shape[1] > 1 else self.dec)(q, k, v, scale, causal)


class StepTimer:
    """Wraps the model's ``prefill`` and ``decode_step``: the device-synced
    wall time of every call, and the caches the last call returned."""

    def __init__(self, M):
        self.M, self.pre, self.dec = M, M.prefill, M.decode_step
        self.prefill_ms, self.step_ms, self.caches = [], [], None

    def _timed(self, fn, out):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
            self.caches = r[1]
            return r
        return run

    def __enter__(self):
        self.M.prefill = self._timed(self.pre, self.prefill_ms)
        self.M.decode_step = self._timed(self.dec, self.step_ms)
        return self

    def __exit__(self, *exc):
        self.M.prefill, self.M.decode_step = self.pre, self.dec


def device_bytes(tree) -> int:
    """Bytes of the CUDA tensors of a cache tree (a container's length lives
    on the host)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size() if tree.is_cuda else 0
    if isinstance(tree, dict):
        tree = list(tree.values())
    return sum(device_bytes(t) for t in tree)


def counted_launches(counted: list, routes: dict) -> dict:
    """The launch counts of ``counted`` (module, wrapper name) pairs, and of
    B8's routes as ``flash_attention/<route>``."""
    return {**{name: getattr(mod, name).launches for mod, name in counted},
            **{f"flash_attention/{r}": n for r, n in routes.items()}}


def zero_launches(counted: list, routes: dict) -> None:
    for mod, name in counted:
        getattr(mod, name).launches = 0
    for r in routes:
        routes[r] = 0


def serve_static(eng, T, M, prompts, n_new: int, recorders: dict, counted: list,
                 routes: dict):
    """One static generate with each kernel wrapper replaced by its Recorder,
    every launch count of ``counted`` (module, wrapper name) pairs and of
    B8's ``routes`` set to 0 just before and read just after. Returns
    (tokens, stats, StepTimer, wall s, counts)."""
    for name, (mod, rec) in recorders.items():
        setattr(mod, name, rec)
    zero_launches(counted, routes)
    try:
        with StepTimer(M) as timer:
            t0 = time.perf_counter()
            out, stats = eng.generate(prompts, T.GenerationConfig(max_new_tokens=n_new))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for name, (mod, rec) in recorders.items():
            setattr(mod, name, rec.fn)
    return out, stats, timer, wall, counted_launches(counted, routes)


def static_metrics(out, stats, timer, wall, what: str) -> dict:
    step = float(np.median(timer.step_ms))
    B = out.shape[0]
    m = {"prefill_ms": timer.prefill_ms[0], "decode_steps": stats["decode_steps"],
         "decode_step_ms_median": step,
         "decode_step_ms_p90": float(np.percentile(timer.step_ms, 90)),
         "decode_tokens_per_s": B / step * 1e3, "generated_tokens": stats["generated_tokens"],
         "serve_wall_s": wall, "end_to_end_tokens_per_s": stats["generated_tokens"] / wall,
         "arena_bytes": device_bytes(timer.caches)}
    log(f"serve static {what}: prefill {m['prefill_ms']:.3f} ms; decode step median "
        f"{step:.3f} ms (p90 {m['decode_step_ms_p90']:.3f}) over {len(timer.step_ms)} steps "
        f"of {B} rows = {m['decode_tokens_per_s']:.1f} tokens/s; end to end "
        f"{m['end_to_end_tokens_per_s']:.1f} tokens/s over {wall:.2f} s; arena "
        f"{m['arena_bytes'] / 1e9:.3f} GB")
    return m


def flash_bound(q, S, KV, Dv, causal):
    """(bytes, flops) one B8 call needs: q, the S keys and values, out once
    each; 2 (Dh + Dv) flops per (query, key) pair it sees (causal: key j <=
    query i, T == S)."""
    B, T, H, Dh = q.shape
    elt = q.element_size()
    pairs = T * (T + 1) // 2 if causal else T * S
    nbytes = (q.numel() + B * S * KV * (Dh + Dv) + B * T * H * Dv) * elt
    return nbytes, 2.0 * B * H * pairs * (Dh + Dv)


def flash_prefill_case(fa_ops, scale, causal: bool = True):
    """B8 at a sampled prompt call (causal over the prompt, or not: the
    cross-attention over the patch keys); the yardstick is
    scaled_dot_product_attention on the same q, k, v."""
    def make(sample, k0, v0):
        (q,) = sample
        gqa = {"enable_gqa": True} if q.shape[2] != k0.shape[2] else {}
        return (lambda k, v: fa_ops.flash_attention(q, k, v, scale, causal),
                lambda: fa_ops.flash_attention_plain(q, k0, v0, scale, causal),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k0.transpose(1, 2), v0.transpose(1, 2),
                    is_causal=causal, scale=scale, **gqa),
                flash_bound(q, k0.shape[1], k0.shape[2], v0.shape[3], causal))
    return make


def flash_decode_case(fa_ops, scale):
    """B8 at a sampled static dense decode call, over the first S keys of
    each layer's arena; the yardstick is scaled_dot_product_attention on the
    same prefix."""
    def make(sample, k0, v0):
        q, S = sample
        gqa = {"enable_gqa": True} if q.shape[2] != k0.shape[2] else {}
        return (lambda k, v: fa_ops.flash_attention(q, k[:, :S], v[:, :S], scale, False),
                lambda: fa_ops.flash_attention_plain(q, k0[:, :S], v0[:, :S], scale, False),
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q.transpose(1, 2), k0[:, :S].transpose(1, 2), v0[:, :S].transpose(1, 2),
                    scale=scale, **gqa),
                flash_bound(q, S, k0.shape[2], v0.shape[3], False))
    return make


def t1c_recorder(t1_ops, n_layers: int) -> Recorder:
    """B9's Recorder: each layer's X and roped-key arenas, and a sample of
    R, q_rope and the length as the kernel gets them."""
    return Recorder(t1_ops.decomposed_decode, n_layers, 10, lambda qn, qr, x, kr, *r: (x, kr),
                    lambda qn, qr, x, kr, ln, wk, wv, s: (
                        t1_ops.query_rows(qn, wk, x.dtype)[:, 0],
                        qr[:, 0].to(x.dtype).contiguous(), ln))


def cpqc_recorder(cpq_ops, n_layers: int) -> Recorder:
    """B10's Recorder: each layer's K and V codes, and a sample of the
    float32 query grouped by kv head and the length."""
    return Recorder(cpq_ops.cpq_decode, n_layers, 10, lambda q, kt, vt, *r: (kt, vt),
                    lambda q, kt, vt, ln, *r: (q[:, 0].reshape(q.shape[0], kt.codes.shape[2],
                                                               -1, q.shape[3]).float()
                                               .contiguous(), ln))


def t3c_recorder(t3_ops, n_layers: int) -> Recorder:
    """B7's Recorder in its contiguous form (``proxy_scores_q``, the static
    T3 decode): each layer's codes and proxy tables, and a sample of the
    pre-scaled query and the length."""
    return Recorder(t3_ops.proxy_scores_q, n_layers, 10, lambda q, sc, z, codes, ln: (codes,
                                                                                     (sc, z)),
                    lambda q, sc, z, codes, ln: (q.clone(), int(ln)))


def t3c_decode_case(t3_ops):
    """B7 at a sampled static T3 decode call (``proxy_scores_q``: one launch
    that forms the query factors and scores the first ``length`` keys); the
    yardstick is torch.matmul of the factors, formed beforehand, against the
    written codes shifted by 128 and converted to float32 beforehand, plus
    qz."""
    def make(sample, codes0, tables0):
        q, length = sample
        qs, qz = t3_ops.query_factors(q, *tables0)
        cg = (codes0[:, :length].float() + 128.0).permute(0, 2, 3, 1).contiguous()
        n = torch.tensor(length, device=q.device)  # the plain mask's length, on the card
        return (lambda codes, tables: t3_ops.proxy_scores_q(q, *tables, codes, length),
                lambda: t3_ops.proxy_scores_plain(qs, qz, codes0, n),
                lambda: torch.matmul(qs, cg) + qz,
                t3c_bound(q, tables0, length, codes0))
    return make


def t3c_bound(q, tables, length, codes0):
    """(bytes, flops, float32 flops) one contiguous B7 call needs: the first
    ``length`` codes of every row, q, the proxy scale and zero tables and
    the N scores of every row written; one float32 multiply-add per written
    code and query head."""
    B, H = q.shape[:2]
    N, KV, Dp = codes0.shape[1:]
    nbytes = (B * length * KV * Dp + q.numel() * q.element_size() + 2 * tables[0].numel() * 4
              + B * H * N * 4)
    return nbytes, 0.0, 2.0 * B * length * H * Dp


def t1c_bound(r, qr, length, x0, kr0):
    """(bytes, flops) one B9 call needs: the first ``length`` X rows and
    roped keys of every row, R and q_rope, P once each."""
    B, H, Dm = r.shape
    elt = x0.element_size()
    nbytes = (B * length * (Dm + kr0.shape[2] * kr0.shape[3]) + r.numel() + qr.numel()
              + B * H * Dm) * elt
    return nbytes, 2.0 * B * length * H * (2 * Dm + qr.shape[-1])


def t1c_decode_case(t1_ops, scale):
    """B9 at a sampled static T1 decode call; the yardstick is
    scaled_dot_product_attention with q = [R | q_rope], k = [X | roped key],
    v = X over the written prefix, as for B3."""
    def make(sample, x0, kr0):
        r, qr, length = sample
        qq, kk, vv = _t1_sdpa_operands(r[:, None], qr[:, None], x0[:, :length],
                                       kr0[:, :length])
        return (lambda x, kr: t1_ops.decomposed_decode_fwd(r, qr, x, kr, length, scale),
                lambda: t1_ops.decomposed_decode_plain(r, qr, x0, kr0, length, scale),
                lambda: torch.nn.functional.scaled_dot_product_attention(qq, kk, vv,
                                                                         scale=scale),
                t1c_bound(r, qr, length, x0, kr0))
    return make


def cpqc_bound(q, length, kt, vt):
    """(bytes, flops, float32 flops) one B10 call needs: the first
    ``length`` codes and levels of every row, every row's tables, q (float32)
    and out once each; the attention's and the dequantization's float32
    operations."""
    B, KV, G, Dh = q.shape
    Dv = vt.codes.shape[3]
    nbytes = (B * length * KV * (Dh + Dv + 2 * 4) + 2 * 4 * (kt.scale.numel() + vt.scale.numel())
              + 4 * (q.numel() + B * KV * G * Dv))
    return nbytes, 0.0, 2.0 * B * length * KV * (G + 1) * (Dh + Dv)


def cpqc_decode_case(cpq_ops, scale):
    """B10 at a sampled static T2 decode call (rounded tiles, the served
    function); the yardstick is scaled_dot_product_attention on K/V
    dequantized (to bf16) and sliced to the written prefix beforehand."""
    from repro_torch.core.cpq import cpq_dequant

    def make(sample, kt0, vt0):
        q, length = sample                      # q (B, KV, G, Dh) float32
        B, KV, G, Dh = q.shape
        kg = cpq_dequant(kt0)[:, :length].transpose(1, 2)   # (B, KV, n, Dh) bf16
        vg = cpq_dequant(vt0)[:, :length].transpose(1, 2)
        qq = q.reshape(B, KV * G, 1, Dh).to(torch.bfloat16)
        gqa = {"enable_gqa": True} if G > 1 else {}

        def kern(kt, vt):
            return cpq_ops.cpq_decode_fwd(q, kt.codes, vt.codes, kt.scale, kt.zero, vt.scale,
                                          vt.zero, kt.level, vt.level, length, scale, True)
        return (kern,
                lambda: cpq_ops.cpq_decode_plain(q, kt0.codes, vt0.codes, kt0.scale, kt0.zero,
                                                 vt0.scale, vt0.zero, kt0.level, vt0.level,
                                                 length, scale, True),
                lambda: torch.nn.functional.scaled_dot_product_attention(qq, kg, vg,
                                                                         scale=scale, **gqa),
                cpqc_bound(q, length, kt0, vt0))
    return make


def profile_static(make_engine, T, M, prompts, n_new, step_ms, lo: int, hi: int) -> dict:
    """Replays the static serve and profiles decode steps lo .. hi-1 with
    torch.profiler: device time by kernel and the device's busy share of
    those steps' unprofiled wall time (``step_ms`` of the measured run)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng, dec, calls = make_engine(), M.decode_step, [0]
    prof = profile(activities=[ProfilerActivity.CUDA])

    def step(*a, **kw):
        if calls[0] == lo:
            torch.cuda.synchronize()
            prof.__enter__()
        r = dec(*a, **kw)
        calls[0] += 1
        if calls[0] == hi:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
        return r

    M.decode_step = step
    try:
        eng.generate(prompts, T.GenerationConfig(max_new_tokens=n_new))
    finally:
        M.decode_step = dec
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
                     key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kernels)
    wall = sum(step_ms[lo:hi])
    attn = sum(ms for k, ms, _ in kernels if any(a in k for a in ATTENTION_KERNELS))
    gemm = sum(ms for k, ms, _ in kernels if any(g in k for g in ("gemm", "nvjet", "cutlass", "xmma")))
    return {"ticks": [lo, hi], "decode_only_ticks": hi - lo, "device_busy_ms": busy,
            "unprofiled_wall_ms": wall, "busy_share": busy / wall, "attn_ms": attn,
            "gemm_ms": gemm, "top_kernels": [{"name": k, "ms": ms, "count": n}
                                             for k, ms, n in kernels[:12]]}


def encode_parity(k, v, cpq_cfg, t3_cfg, split: int) -> dict:
    """The T2 and T3 encoders on the card against the same on the CPU (no
    gate): one layer's K/V history (B, N, KV, D), its first ``split`` tokens
    compressed at once (``cpq_compress_prefill``; T3: ``fit_proxy``), the
    rest appended token by token (``cpq_append_decode``, which may spawn HQE
    levels; T3: ``encode_proxy``), as the static engine does. Returns how
    many codes, levels and tables differ between the two devices."""
    from repro_torch.core import cpq as C
    from repro_torch.core import retrieval_attention as R

    def hqe(x):
        t = C.cpq_compress_prefill(x[:, :split], cpq_cfg, x.shape[1])
        for pos in range(split, x.shape[1]):
            t = C.cpq_append_decode(t, x[:, pos:pos + 1], pos, cpq_cfg)
        return t

    def proxy(x):
        dp = t3_cfg.proxy_dim or x.shape[-1]
        codes, sc, z = R.fit_proxy(x[:, :split, :, :dp], t3_cfg.proxy_bits)
        return codes, R.encode_proxy(x[:, split:, :, :dp], sc, z, t3_cfg.proxy_bits), sc, z

    out = {}
    for name, x in (("K", k), ("V", v)):
        card, cpu = hqe(x), hqe(x.cpu())
        out[f"hqe {name}"] = {
            "codes": card.codes.numel(),
            "codes_differ": int((card.codes.cpu() != cpu.codes).sum()),
            "levels_differ": int((card.level.cpu() != cpu.level).sum()),
            "num_levels_differ": int((card.num_levels.cpu() != cpu.num_levels).sum()),
            "table_max_abs_diff": max((card.scale.cpu() - cpu.scale).abs().max().item(),
                                      (card.zero.cpu() - cpu.zero).abs().max().item())}
    card, cpu = proxy(k), proxy(k.cpu())
    out["proxy K"] = {
        "codes": card[0].numel() + card[1].numel(),
        "fit_codes_differ": int((card[0].cpu() != cpu[0]).sum()),
        "encode_codes_differ": int((card[1].cpu() != cpu[1]).sum()),
        "table_max_abs_diff": max((card[2].cpu() - cpu[2]).abs().max().item(),
                                  (card[3].cpu() - cpu[3]).abs().max().item())}
    return out


# -------------------------------------------------------- phase 5: parity


class SharedKV:
    """Lockstep runs on one history. While recording, every attention call
    keeps the K/V it writes into its arena (paged: a decode token or a
    prompt chunk; contiguous: a whole prompt or a decode token); while
    replaying, the matching call of the second run writes those instead of
    its own. Both runs then attend over arenas of the same contents, each
    with its own queries."""

    def __init__(self):
        from repro_torch.core import attention as core_attn
        from repro_torch.serving import paged_cache as pgc

        self.pgc, self.core, self.kept, self.record = pgc, core_attn, [], True
        self.decode, self.chunk = pgc.decode_attend_paged, pgc.chunk_attend_paged
        self.c_prefill, self.c_decode = core_attn.prefill_into_cache, core_attn.decode_attend

    def _take(self, k, v):
        if self.record:
            self.kept.append((k, v))
            return k, v
        return self.kept.pop(0)

    def __enter__(self):
        def decode(rt, cache, rows, *, k_t, v_t, **kw):
            k_t, v_t = self._take(k_t, v_t)
            return self.decode(rt, cache, rows, k_t=k_t, v_t=v_t, **kw)

        def chunk(rt, cache, *, k_c, v_c, **kw):
            k_c, v_c = self._take(k_c, v_c)
            return self.chunk(rt, cache, k_c=k_c, v_c=v_c, **kw)

        def c_prefill(rt, cache, *, k, v, **kw):
            k, v = self._take(k, v)
            return self.c_prefill(rt, cache, k=k, v=v, **kw)

        def c_decode(rt, cache, *, k_t, v_t, **kw):
            k_t, v_t = self._take(k_t, v_t)
            return self.c_decode(rt, cache, k_t=k_t, v_t=v_t, **kw)

        self.pgc.decode_attend_paged, self.pgc.chunk_attend_paged = decode, chunk
        self.core.prefill_into_cache, self.core.decode_attend = c_prefill, c_decode
        return self

    def __exit__(self, *exc):
        self.pgc.decode_attend_paged, self.pgc.chunk_attend_paged = self.decode, self.chunk
        self.core.prefill_into_cache, self.core.decode_attend = self.c_prefill, self.c_decode


def pair(recorders, first_fn, second_fn):
    """Run ``first_fn`` with every lockstep recorder (SharedKV,
    SelectionPin) recording, then ``second_fn`` replaying it."""
    for r in recorders:
        r.record = True
    a = first_fn()
    for r in recorders:
        r.record = False
    b = second_fn()
    check(not any(r.kept for r in recorders), "parity: the two runs made different calls")
    return a, b


class TopkWitness(StandIn):
    """Installed in place of the served B7 wrapper ``paged_proxy_scores``:
    on every ``every``-th decode tick (all layers), the call's inputs are
    also scored by B7's plain version and by the gather path's
    ``proxy_scores`` (the reference's einsum order over the gathered codes),
    each picks its top-k as the engine does, and the (row, head, layer)
    sets that differ from the kernel's are counted: rows whose proxy scores
    lie within an ulp at the top-k boundary can swap a key. A witness only;
    nothing is gated on it."""

    def __init__(self, t3_ops, cfg, n_layers: int, every: int = 8):
        from repro_torch.core import retrieval_attention as ret_lib
        from repro_torch.serving.paged_cache import gather_pages

        self.ops, self.cfg, self.n_layers, self.every = t3_ops, cfg, n_layers, every
        self.fn = t3_ops.paged_proxy_scores
        self.ret_lib, self.gather_pages = ret_lib, gather_pages
        self.select = ret_lib.select_topk
        self.calls = self.sets = self.differ_plain = self.differ_gather = 0

    def __enter__(self):
        self.ops.paged_proxy_scores = self
        return self

    def __exit__(self, *exc):
        self.ops.paged_proxy_scores = self.fn

    def _sets(self, s, lengths):
        return self.select(s[:, None], lengths, self.cfg)[:, 0].sort(-1).values

    def __call__(self, q, sc, z, codes, bt, lengths, n, q_scale=None):
        out = self.fn(q, sc, z, codes, bt, lengths, n, q_scale=q_scale)
        q = q if q_scale is None else q * q_scale  # the pre-scaled query, as served
        if (self.calls // self.n_layers) % self.every == 0:
            plain = self.ops.paged_proxy_scores_plain(q, sc, z, codes, bt, lengths, n)
            gather = self.ret_lib.proxy_scores(
                q[:, None], self.gather_pages(codes, bt)[:, :n], sc, z)[:, 0]
            kern, live = self._sets(out, lengths), lengths > 0
            self.sets += int(live.sum().item()) * q.shape[1]
            for name, other in (("differ_plain", plain), ("differ_gather", gather)):
                differ = (self._sets(other, lengths) != kern).any(-1)[live]
                setattr(self, name, getattr(self, name) + int(differ.sum().item()))
        self.calls += 1
        return out


class SelectionPin:
    """T3's top-k choices in lockstep across the two paths of a parity run.
    While recording (the kernel path), every ``select_topk`` call keeps its
    choice; while replaying (the gather path), the matching call makes its
    own choice from its own proxy scores, measures how far it is from the
    recorded one, and returns the recorded one, so both paths attend the
    same keys. Where the two choices differ, ``gap`` is how far the gather
    path's own scores rank the keys only it picked above those only the
    kernel path picked, relative to the largest live |score| of that (row,
    head): a swap at a near-tie of the boundary has a gap near 0."""

    def __init__(self):
        from repro_torch.core import retrieval_attention as ret_lib

        self.ret_lib, self.select = ret_lib, ret_lib.select_topk
        self.kept, self.record = [], True
        self.sets = self.differ = 0
        self.max_gap = 0.0

    def __enter__(self):
        self.ret_lib.select_topk = self._call
        return self

    def __exit__(self, *exc):
        self.ret_lib.select_topk = self.select

    def _call(self, s_proxy, length, cfg, query_positions=None):
        idx = self.select(s_proxy, length, cfg, query_positions)
        if self.record:
            self.kept.append(idx)
            return idx
        pinned = self.kept.pop(0)
        own = torch.zeros(s_proxy.shape, dtype=torch.bool, device=idx.device)
        own.scatter_(-1, idx, True)
        pin = torch.zeros_like(own).scatter_(-1, pinned, True)
        differ = (own != pin).any(-1)
        live = torch.arange(s_proxy.shape[-1], device=idx.device) < torch.as_tensor(
            length, device=idx.device).reshape(-1, 1, 1, 1)
        self.sets += int(live.any(-1).expand(differ.shape).sum().item())
        if differ.any():
            hi = torch.where(own & ~pin, s_proxy, -torch.inf).amax(-1)[differ]
            lo = torch.where(pin & ~own, s_proxy, torch.inf).amin(-1)[differ]
            top = torch.where(live, s_proxy.abs(), 0.0).amax(-1)[differ]
            self.differ += int(differ.sum().item())
            self.max_gap = max(self.max_gap, ((hi - lo) / top).max().item())
        return pinned


def top2_gap(logits: torch.Tensor) -> torch.Tensor:
    top2 = logits.topk(2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def gather_gaps(M, eng, gaps: dict):
    """``eng.step`` that also files the gather path's top-2 logit gap of
    every token it emits under (rid, index). A tick emits its admissions'
    first tokens before the decode step's: chunked, the tick's last prompt
    chunk's (one chunk per tick); one-shot, each admission's prefill, in
    order; then the decode step's tokens in slot order."""
    seen = {}
    dec, chunk, pre = M.decode_step_rows, M.prefill_chunk_rows, M.prefill

    def keep_decode(*a):
        out = dec(*a)
        seen["decode"] = (top2_gap(out[0]).tolist(), a[4].active.nonzero()[:, 0].tolist())
        return out

    def keep_chunk(*a):
        out = chunk(*a)
        seen["chunk"] = top2_gap(out[0][0]).item()
        return out

    def keep_prefill(*a, **kw):
        out = pre(*a, **kw)
        seen["oneshot"].append(top2_gap(out[0][0]).item())
        return out

    def step():
        seen.clear()
        seen["oneshot"] = []
        M.decode_step_rows, M.prefill_chunk_rows, M.prefill = keep_decode, keep_chunk, keep_prefill
        try:
            events = eng.step()
        finally:
            M.decode_step_rows, M.prefill_chunk_rows, M.prefill = dec, chunk, pre
        admitted = len(seen["oneshot"])
        for e, g in zip(events, seen["oneshot"]):
            gaps[(e.rid, e.index)] = g
        decoded = [e for e in events[admitted:] if admitted or e.index > 0]
        if decoded:
            row_gaps, slots = seen["decode"]
            for e, slot in zip(decoded, slots):
                gaps[(e.rid, e.index)] = row_gaps[slot]
        for e in events[admitted:]:
            if not admitted and e.index == 0:
                gaps[(e.rid, 0)] = seen["chunk"]
        return events
    return step


def first_logits(M, cfg, rt, params, reqs, small, bt, device=None):
    """Two slots (the shortest and the longest prompt) streamed chunk by
    chunk through prefill_chunk_rows, or admitted one-shot when
    ``small.prefill_chunk`` is 0 (the prompt padded to the bucket, prefilled
    as a B=1 contiguous cache and packed into its pages), then one decode
    step: the prompt logits of each slot (2, V) and the decode logits (2, V).
    On DEVICE unless ``device`` names another (the params' own)."""
    from repro_torch.serving.paged_cache import RowState

    dev = device or DEVICE
    caches = M.init_paged_caches(cfg, rt, small, dev)
    C, bucket = small.prefill_chunk, small.prefill_bucket
    pre = []
    for s in range(2):
        ctx, row = reqs[s].prompt, torch.tensor(bt[s], device=dev)
        if not C:
            n = len(ctx)
            pad = max(bucket, -(-n // bucket) * bucket)
            tok = np.concatenate([ctx, np.full(pad - n, ctx[-1], np.int32)])
            logits, ctg = M.prefill(cfg, rt, params, {"tokens": torch.tensor(tok[None],
                                                                        device=dev)},
                                    M.init_caches(cfg, rt, 1, pad, dev), last_index=n - 1)
            M.pack_prefill_caches(cfg, rt, caches, ctg, row, s)
        for off in range(0, len(ctx), C) if C else ():
            valid = min(C, len(ctx) - off)
            tok = np.concatenate([ctx[off:off + valid],
                                  np.full(C - valid, ctx[off + valid - 1], np.int32)])
            logits, _ = M.prefill_chunk_rows(cfg, rt, 0, off == 0, params,
                                             torch.tensor(tok[None], device=dev), s, row,
                                             off, valid, caches)
        pre.append(logits)
    first = torch.cat([p.argmax(-1) for p in pre]).to(torch.int32)
    lens = [len(reqs[0].prompt), len(reqs[1].prompt)]
    rows = RowState(lengths=torch.tensor(lens, dtype=torch.int32, device=dev),
                    block_table=torch.tensor(bt, device=dev),
                    active=torch.ones(2, dtype=torch.bool, device=dev),
                    tier=torch.zeros(2, dtype=torch.int32, device=dev))
    dec, _ = M.decode_step_rows(cfg, rt, params, first[:, None], rows, caches)
    return torch.cat(pre), dec


def max_diff(got) -> dict:
    return {f"{name}_logits_max_abs_diff": (got[0][i] - got[1][i]).abs().max().item()
            for i, name in enumerate(("prefill", "first-decode"))}


def parity(T, M, cfg, params, reqs, mode: str, rt_kw=None, serving_kw=None) -> dict:
    """Kernels on vs the gather path in float32 for attention ``mode`` (with
    the runtime's other settings ``rt_kw`` and the serving ones
    ``serving_kw``: ``prefill_chunk=0`` admits one-shot):
    chunked-prefill and first-decode logits of two slots, then the greedy
    streams of the served requests. Dense and decomposed (T1, which
    re-quantizes nothing) run each path on its own history. CPQ runs the two
    in lockstep on one history (SharedKV): each path compresses the K/V it
    computed, which differ in the last ulp, and 4-bit codes can turn that
    into whole quantization steps, which the next layer's K/V then carry
    (PERF.md). T3 (retrieval) runs in lockstep too, for the same reason
    (int8 proxy codes of K/V that differ in the last ulp differ by a whole
    step), and with its top-k choices pinned (``SelectionPin``): the two
    paths' queries still differ in the last ulps, which can swap a key at
    the top-k boundary, and one swap moves the next logits by ~1e-3
    (PERF.md). So the gather path attends the keys the kernel path chose,
    every choice of its own that differs must differ by a swap within
    TOPK_GAP of the boundary, and the logits and streams are held as for
    the other modes; the unpinned first-decode logits are reported."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = (True, False)
    rts = {fused: T.AttentionRuntime(mode=mode, paged_kernels=fused, **(rt_kw or {}))
           for fused in paths}
    lockstep, pinned = mode in ("cpq", "retrieval"), mode == "retrieval"
    what = mode if (serving_kw or {}).get("prefill_chunk", 1) else f"oneshot {mode}"
    small = T.ServingCfg(num_slots=2, page_size=16, num_pages=80, max_blocks_per_slot=64,
                         **(serving_kw or {}))
    bt = np.zeros((2, 64), np.int32)
    lens = [len(reqs[0].prompt), len(reqs[1].prompt)]
    perm = np.random.default_rng(SEED).permutation(np.arange(1, 80))
    bt[0, :lens[0] // 16 + 1] = perm[:lens[0] // 16 + 1]
    bt[1, :lens[1] // 16 + 1] = perm[40:40 + lens[1] // 16 + 1]
    run = {f: (lambda f=f: first_logits(M, cfg, rts[f], params, reqs, small, bt))
           for f in paths}
    out = {}
    if pinned:
        with SharedKV() as shared:
            own = pair([shared], run[True], run[False])
        err = (own[0][1] - own[1][1]).abs().max().item()
        out["unpinned_first-decode_logits_max_abs_diff"] = err
        log(f"parity {what}: unpinned first-decode_logits_max_abs_diff {err:.3e} (no gate)")
    if lockstep:
        with SharedKV() as shared, pin_if(pinned) as pin:
            got = pair([shared] + [pin] * pinned, run[True], run[False])
        if pinned:
            out.update(pin_report(what, "first logits", pin))
    else:
        got = (run[True](), run[False]())
    check_logits(what, got, out)

    serving = T.ServingCfg(num_slots=8, page_size=16, num_pages=513,
                           max_blocks_per_slot=64, **(serving_kw or {}))
    engs = {f: T.ContinuousServeEngine(cfg, params, rt=rts[f], serving=serving,
                                       device=DEVICE) for f in paths}
    for eng in engs.values():
        eng.reset(T.GenerationConfig())
        for r in make_requests(T, cfg.vocab_size):
            eng.add_request(r)
    gaps = {}
    step = gather_gaps(M, engs[False], gaps)
    if lockstep:
        with SharedKV() as shared, pin_if(pinned) as pin:
            while engs[True].has_unfinished():
                pair([shared] + [pin] * pinned, engs[True].step, step)
        if pinned:
            out.update(pin_report(what, "streams", pin))
    else:
        while engs[True].has_unfinished():
            engs[True].step()
        while engs[False].has_unfinished():
            step()
    streams = {f: {rid: res["tokens"] for rid, res in engs[f].results().items()} for f in paths}
    del engs
    out["streams_identical"] = compare_streams(what, streams, gaps,
                                               {r.rid: r.max_new_tokens for r in reqs})
    out["lockstep"] = lockstep
    return out


def compare_streams(mode: str, streams: dict, gaps: dict, lengths: dict,
                    names=("kernels", "gather"), gap: float = ARGMAX_GAP) -> int:
    """Greedy streams of the kernel path (``streams[True]``) and the gather
    path (or the two ``names``), by request id: identical, but for a first
    divergence where the gather path's top-2 logit gap is below ``gap``
    (ARGMAX_GAP unless given). Returns the number of identical streams."""
    excused = 0
    for rid, n in lengths.items():
        a, b = streams[True][rid], streams[False][rid]
        check(len(a) == len(b) == n, f"parity {mode}: request {rid} lengths")
        diff = np.flatnonzero(a != b)
        if not len(diff):
            continue
        t = int(diff[0])   # after a divergence the contexts differ: stop there
        at = gaps[(rid, t)]
        log(f"parity {mode}: request {rid} diverges at token {t}: {names[0]} {a[t]} vs "
            f"{names[1]} {b[t]}, {names[1]} top-2 gap {at:.3e}")
        check(at < gap, f"parity {mode}: request {rid} token {t} differs at a "
              f"resolvable gap {at:.3e} (tie below {gap:.1e})")
        excused += 1
    log(f"parity {mode}: greedy streams identical for {len(lengths) - excused}/"
        f"{len(lengths)} requests, {excused} near-tie divergences excused")
    return len(lengths) - excused


def check_logits(mode: str, got, out: dict) -> None:
    """Prefill and first-decode logits of the two paths within LOGIT_TOL."""
    for i, (name, err) in enumerate(max_diff(got).items()):
        out[name] = err
        log(f"parity {mode}: {name} {err:.3e} (atol=rtol={LOGIT_TOL})")
        check(torch.allclose(got[0][i], got[1][i], atol=LOGIT_TOL, rtol=LOGIT_TOL),
              f"parity {mode}: {name} {err:.3e}")


def static_first_logits(M, cfg, rt, params, prompts):
    """The static engine's prefill logits of the batch and the first decode
    step's (its argmax fed back)."""
    batch = {k: torch.as_tensor(v, device=DEVICE) for k, v in prompts.items()}
    B, S = (batch["tokens"] if "tokens" in batch else batch["frames"]).shape[:2]
    caches = M.init_caches(cfg, rt, B, S + 1, DEVICE)
    pre, caches = M.prefill(cfg, rt, params, batch, caches)
    dec, _ = M.decode_step(cfg, rt, params, pre.argmax(-1).to(torch.int32)[:, None], S, caches)
    return pre, dec


def static_gaps(M, gaps: dict):
    """A context in which the model's ``prefill`` and ``decode_step`` file
    the top-2 logit gap of every row's token under (row, index)."""
    pre, dec = M.prefill, M.decode_step
    count = [0]

    def keep_pre(*a, **kw):
        out = pre(*a, **kw)
        for row, g in enumerate(top2_gap(out[0]).tolist()):
            gaps[(row, 0)] = g
        return out

    def keep_dec(*a, **kw):
        out = dec(*a, **kw)
        count[0] += 1
        for row, g in enumerate(top2_gap(out[0]).tolist()):
            gaps[(row, count[0])] = g
        return out

    @contextlib.contextmanager
    def ctx():
        M.prefill, M.decode_step = keep_pre, keep_dec
        try:
            yield
        finally:
            M.prefill, M.decode_step = pre, dec
    return ctx()


def static_parity(T, M, cfg, params, prompts, mode: str, n_new: int, rt_kw=None,
                  what: str | None = None) -> dict:
    """The static engine with its contiguous kernels (B8, B9, B10, B7) on
    and off, in float32: prefill and first-decode logits of the batch within
    LOGIT_TOL, then the greedy streams of ``n_new`` tokens. CPQ and T3 run in
    lockstep on one K/V history, T3 with its top-k choices pinned, as in
    ``parity``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = (True, False)
    rts = {f: T.AttentionRuntime(mode=mode, paged_kernels=f, **(rt_kw or {})) for f in paths}
    lockstep, pinned = mode in ("cpq", "retrieval"), mode == "retrieval"
    what = what or f"static {mode}"
    run = {f: (lambda f=f: static_first_logits(M, cfg, rts[f], params, prompts)) for f in paths}
    out = {}
    if lockstep:
        with SharedKV() as shared, pin_if(pinned) as pin:
            got = pair([shared] + [pin] * pinned, run[True], run[False])
        if pinned:
            out.update(pin_report(what, "first logits", pin))
    else:
        got = (run[True](), run[False]())
    check_logits(what, got, out)
    engs = {f: T.ServeEngine(cfg, params, rt=rts[f], device=DEVICE) for f in paths}
    gen = T.GenerationConfig(max_new_tokens=n_new)
    gaps = {}

    def gather():
        with static_gaps(M, gaps):
            return engs[False].generate(prompts, gen)[0]

    if lockstep:
        with SharedKV() as shared, pin_if(pinned) as pin:
            a, b = pair([shared] + [pin] * pinned,
                        lambda: engs[True].generate(prompts, gen)[0], gather)
        if pinned:
            out.update(pin_report(what, "streams", pin))
    else:
        a, b = engs[True].generate(prompts, gen)[0], gather()
    out["streams_identical"] = compare_streams(
        what, {True: dict(enumerate(a)), False: dict(enumerate(b))}, gaps,
        {row: n_new for row in range(len(a))})
    out["lockstep"] = lockstep
    return out


def pin_if(pinned: bool):
    return SelectionPin() if pinned else contextlib.nullcontext()


def pin_report(mode: str, what: str, pin: SelectionPin) -> dict:
    """Log and gate the top-k choices of a pinned parity run."""
    log(f"parity {mode} {what}: {pin.differ} of {pin.sets} (row, head, layer) top-k sets "
        f"the gather path chose differ from the kernel path's; largest relative gap "
        f"{pin.max_gap:.3e} (tie below {TOPK_GAP})")
    check(pin.max_gap <= TOPK_GAP, f"parity {mode} {what}: a top-k choice differs at a "
          f"resolvable gap {pin.max_gap:.3e}")
    key = what.replace(" ", "_")
    return {f"{key}_topk_sets": pin.sets, f"{key}_topk_sets_differ": pin.differ,
            f"{key}_topk_max_rel_gap": pin.max_gap}


# ------------------------- phase 6: the DeepSeek stacks and T1+T2 (T1 + CPQ)

DEEPSEEK_SERVING = dict(num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64,
                        prefill_chunk=0, prefill_bucket=16)  # (a)'s arena, one-shot
MOE_DEPTH = 4               # layers of serve (m): deepseek-moe-16b's dense layer and 3 MoE
                            # (8 until phase 8 came: cut to keep the script's time)
DCPQ_DEPTH = 6              # layers of serve (l) (of 24; cut to 12 for phase 7, to 6 for 8)
ROUTER_GAP = 1e-5           # relative top-k boundary gap of the router below which a flip is a tie


def deepseek_config(T, name: str, num_blocks: int | None = None):
    """A DeepSeek config at its published widths (``num_blocks`` cuts its
    depth where given)."""
    cfg = T.ARCHS[name]
    check(cfg.d_model == 2048 and cfg.vocab_size == 102400 and cfg.moe.num_experts == 64
          and cfg.moe.top_k == 6 and cfg.moe.num_shared == 2 and cfg.moe.d_ff_expert == 1408,
          f"{name}: not the published widths")
    return cfg if num_blocks is None else dataclasses.replace(cfg, num_blocks=num_blocks)


def head_layers(tree, cfg, depth: int):
    """A parameter tree cut to its first ``depth`` layers, as float32 (the
    prefix layers, then the first blocks)."""
    n = depth - len(cfg.prefix_pattern)
    return _tree_float({**tree, "blocks": [b[:n] for b in tree["blocks"]]})


def serve_counted(eng, T, reqs, counted: list, fa_routes: dict, routed: dict):
    """``serve_timed`` with every launch and route count set to 0 just before
    and read just after."""
    zero_launches(counted, fa_routes)
    zero_routes(routed)
    results, stats, ticks, wall = serve_timed(eng, T, reqs)
    return results, stats, ticks, wall, counted_launches(counted, fa_routes)


def check_counts(what: str, counts: dict, want: dict) -> None:
    full = {name: want.get(name, 0) for name in counts}
    check(counts == full, f"{what}: launch counts {counts}, want {full}")


class RouterLog:
    """Wraps ``models.moe.route`` while it is entered: keeps, for every router
    call, the engine tick it ran in (``tick``, set by the caller), each
    token's top-k experts as a set and the relative gap between the k-th and
    the (k+1)-th largest probability (the top-k boundary)."""

    def __init__(self, moe):
        self.moe, self.calls, self.tick = moe, [], 0

    def __enter__(self):
        self.route = self.moe.route

        def logged(cfg, router, xg):
            out = self.route(cfg, router, xg)
            probs, _, top_e, _ = out
            K = cfg.moe.top_k
            p = probs.sort(dim=-1, descending=True).values[..., :K + 1]
            gap = (p[..., K - 1] - p[..., K]) / p[..., K - 1]
            self.calls.append((self.tick, top_e.sort(dim=-1).values.cpu(), gap.cpu()))
            return out
        self.moe.route = logged
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def first_route_diff(a: RouterLog, b: RouterLog):
    """(tick, call index, relative gap) of the first router call whose top-k
    sets differ between two logs of the same schedule, the gap the largest
    over the tokens that differ of the smaller of the two paths' gaps; and
    the number of calls that differ. (None, count) when none does."""
    first, differ = None, 0
    for i, ((tick, ea, ga), (_, eb, gb)) in enumerate(zip(a.calls, b.calls)):
        d = (ea != eb).any(-1) if ea.shape == eb.shape else None
        if d is None or d.any():
            differ += 1
            if first is None:
                gap = (float("inf") if d is None
                       else torch.minimum(ga, gb)[d].max().item())
                first = (tick, i, gap)
    return first, differ + abs(len(a.calls) - len(b.calls))


def moe_parity(T, M, moe, cfg, params, reqs, what: str, mode: str) -> dict:
    """Kernels on vs the gather path in float32 for a MoE stack, one-shot:
    prefill and first-decode logits of two slots within LOGIT_TOL, then the
    greedy streams and the counters of the served requests, each path on its
    own history. Capacity-factor routing turns a router near tie into a
    different expert, and one flip moves everything after it; so every
    router call of both paths is logged, and where the paths differ the
    first router call whose top-k sets differ must come no later than the
    first tick whose tokens differ and be a near tie (relative top-k
    boundary gap below ROUTER_GAP), or the first tokens that differ must be
    a logit near tie (top-2 gap below ARGMAX_GAP). Such ticks are counted
    and reported."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    paths = (True, False)
    rts = {f: T.AttentionRuntime(mode=mode, paged_kernels=f) for f in paths}
    small = T.ServingCfg(num_slots=2, page_size=16, num_pages=80, max_blocks_per_slot=64,
                         prefill_chunk=0, prefill_bucket=16)
    bt = np.zeros((2, 64), np.int32)
    lens = [len(reqs[0].prompt), len(reqs[1].prompt)]
    perm = np.random.default_rng(SEED).permutation(np.arange(1, 80))
    bt[0, :lens[0] // 16 + 1] = perm[:lens[0] // 16 + 1]
    bt[1, :lens[1] // 16 + 1] = perm[40:40 + lens[1] // 16 + 1]
    out = {}
    logs = {f: RouterLog(moe) for f in paths}
    got = []
    for f in paths:
        with logs[f]:
            got.append(first_logits(M, cfg, rts[f], params, reqs, small, bt))
    first, differ = first_route_diff(logs[True], logs[False])
    errs = max_diff(got)
    out.update(errs)
    out["first_logits_router_calls"], out["first_logits_router_calls_differ"] = (
        len(logs[True].calls), differ)
    for name, err in errs.items():
        log(f"parity {what}: {name} {err:.3e} (atol=rtol={LOGIT_TOL}); {differ} of "
            f"{len(logs[True].calls)} router calls differ")
    close = all(torch.allclose(a, b, atol=LOGIT_TOL, rtol=LOGIT_TOL)
                for a, b in zip(got[0], got[1]))
    check(close or (first is not None and first[2] < ROUTER_GAP),
          f"parity {what}: logits differ past {LOGIT_TOL}, router {first}")

    serving = T.ServingCfg(**DEEPSEEK_SERVING)
    engs = {f: T.ContinuousServeEngine(cfg, params, rt=rts[f], serving=serving, device=DEVICE)
            for f in paths}
    gaps, emitted = {}, {f: [] for f in paths}
    steps = {True: engs[True].step, False: gather_gaps(M, engs[False], gaps)}
    logs = {f: RouterLog(moe) for f in paths}
    for f in paths:
        engs[f].reset(T.GenerationConfig())
        for r in make_requests(T, cfg.vocab_size):
            engs[f].add_request(r)
        with logs[f]:
            while engs[f].has_unfinished():
                emitted[f].append(sorted((e.rid, e.index, e.token) for e in steps[f]()))
                logs[f].tick += 1
    first, differ = first_route_diff(logs[True], logs[False])
    tok_tick = next((i for i, (a, b) in enumerate(zip(emitted[True], emitted[False]))
                     if a != b), None)
    out.update(router_calls=len(logs[True].calls), router_calls_differ=differ,
               first_router_diff=first, first_token_diff_tick=tok_tick)
    log(f"parity {what}: {len(logs[True].calls)} router calls, {differ} differ; first router "
        f"difference (tick, call, relative top-k gap) {first}; first tick whose tokens "
        f"differ {tok_tick}")
    excused = 0
    if tok_tick is not None:
        if first is not None and first[0] <= tok_tick:
            check(first[2] < ROUTER_GAP, f"parity {what}: router call {first[1]} differs at "
                  f"a resolvable relative gap {first[2]:.3e}")
            why = f"after a router near tie (relative gap {first[2]:.3e})"
        else:
            diff = [(a, b) for a, b in zip(emitted[True][tok_tick], emitted[False][tok_tick])
                    if a != b]
            (rid, index, _), _ = diff[0]
            gap = gaps[(rid, index)]
            check(gap < ARGMAX_GAP, f"parity {what}: request {rid} token {index} differs at "
                  f"a resolvable logit gap {gap:.3e}")
            why = f"after a logit near tie (top-2 gap {gap:.3e})"
        streams = {f: {rid: res["tokens"] for rid, res in engs[f].results().items()}
                   for f in paths}
        excused = sum(not np.array_equal(streams[True][r], streams[False][r]) for r in streams[True])
        log(f"parity {what}: {excused} streams differ {why}")
    else:
        check(first is None, f"parity {what}: router calls differ ({first}) but no token does")
    stats = {f: engs[f].stats() for f in paths}
    for key, val in stats[True].items():
        if key not in ("wall_time_s", "tokens_per_s") and tok_tick is None:
            check(np.array_equal(np.asarray(val), np.asarray(stats[False][key])),
                  f"parity {what}: stats[{key}] {val} vs {stats[False][key]}")
    out["streams_identical"] = len(reqs) - excused
    out["streams_excused"] = excused
    log(f"parity {what}: greedy streams identical for {len(reqs) - excused}/{len(reqs)} "
        f"requests; counters {'identical' if tok_tick is None else 'not compared'}")
    del engs
    return out


def serve_deepseek(T, M, counted: list, routed: dict, static_routed: dict, fa_routes: dict,
                   serves: dict, report: dict, new_s: dict) -> None:
    """Phase 6: (k) deepseek-v2-lite at its published widths, 27 layers, in
    bf16 on ContinuousServeEngine (one-shot: a MoE stack), mode decomposed
    (MLA's latent: B8's prompt route per admission and layer, B3 on its
    tensor cores per decode tick and layer) and mode cpq (the latent in CPQ
    codes: B8 alone), and on the static ServeEngine (B8 once per layer, B9
    on its tensor cores per decode step and layer); its f32 parity at
    PARITY_DEPTH layers; (l) qwen1.5-0.5b at DCPQ_DEPTH layers in mode
    decomposed_cpq, chunked on (a)'s arena and static (no kernel but the
    static prefill's B8); (m)
    deepseek-moe-16b at MOE_DEPTH layers, dense, one-shot (B8's prompt
    route, B1's ring) and its f32 parity. Each serve's launch counts are
    set to 0 just before it and read just after."""
    from repro_torch.models import moe
    from repro_torch.params import init_params

    t_all = time.perf_counter()
    cfg = deepseek_config(T, "deepseek-v2-lite-16b")
    check(cfg.num_layers == 27 and cfg.mla.kv_lora_rank == 512 and cfg.d_ff == 10944,
          "deepseek-v2-lite: not the published config")
    L = cfg.num_layers
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, DEVICE)
    torch.cuda.synchronize()
    new_s["deepseek-v2-lite init"] = time.perf_counter() - t0
    log(f"deepseek-v2-lite: {device_bytes(params) / 1e9:.2f} GB of bf16 weights on the card "
        f"in {new_s['deepseek-v2-lite init']:.1f} s")
    serving = T.ServingCfg(**DEEPSEEK_SERVING)
    b3 = {"paged_decomposed_decode": routed["paged_decomposed_decode"]}
    for mode in ("decomposed", "cpq"):
        what = f"deepseek-v2-lite {mode}"
        t0 = time.perf_counter()
        eng = T.ContinuousServeEngine(cfg, params, rt=T.AttentionRuntime(mode=mode),
                                      serving=serving, device=DEVICE)
        run = make_requests(T, cfg.vocab_size)
        results, stats, ticks, wall, counts = serve_counted(eng, T, run, counted, fa_routes,
                                                            routed)
        check_finished(results, run, what)
        check(not stats["chunked_prefill"] and stats["admitted"] == len(run),
              f"{what}: chunked {stats['chunked_prefill']}, {stats['admitted']} admissions")
        want = {"flash_attention": L * stats["admitted"],
                "flash_attention/prompt": L * stats["admitted"]}
        if mode == "decomposed":
            want["paged_decomposed_decode"] = L * stats["decode_steps"]
        check_counts(what, counts, want)
        serves[what] = serve_metrics(stats, ticks, wall, what)
        serves[what].update(launches={k: n for k, n in counts.items() if n},
                            routes=check_routes(what, b3, counts))
        log(f"serve {what}: launches {serves[what]['launches']}, routes "
            f"{serves[what]['routes']}")
        del eng
        torch.cuda.empty_cache()
        new_s[what] = time.perf_counter() - t0
    what = "static deepseek-v2-lite"
    t0 = time.perf_counter()
    eng = T.ServeEngine(cfg, params, rt=T.AttentionRuntime(mode="decomposed"), device=DEVICE)
    prompts, n_new = static_prompts(cfg.vocab_size), 64
    zero_routes(static_routed)
    out, stats, timer, wall, counts = serve_static(eng, T, M, prompts, n_new, {}, counted,
                                                   fa_routes)
    steps = stats["decode_steps"]
    check(out.shape == (8, n_new) and steps == n_new - 1, f"{what}: {out.shape}")
    check_counts(what, counts, {"flash_attention": L, "flash_attention/prompt": L,
                                "decomposed_decode": L * steps})
    serves[what] = static_metrics(out, stats, timer, wall, "deepseek-v2-lite")
    serves[what].update(launches={k: n for k, n in counts.items() if n},
                        routes=check_routes(what, static_routed, counts))
    log(f"serve {what}: launches {serves[what]['launches']}")
    del eng, timer
    new_s[what] = time.perf_counter() - t0
    # free the 31 GB model, keeping its first layers in float32 for the parity
    params_p = head_layers(params, cfg, PARITY_DEPTH)
    del params
    torch.cuda.empty_cache()
    cfg_p = dataclasses.replace(cfg, dtype="float32",
                                num_blocks=PARITY_DEPTH - len(cfg.prefix_pattern))
    t0 = time.perf_counter()
    report["parity"]["deepseek-v2-lite"] = moe_parity(
        T, M, moe, cfg_p, params_p, make_requests(T, cfg.vocab_size),
        "deepseek-v2-lite decomposed", "decomposed")
    del params_p
    torch.cuda.empty_cache()
    new_s["parity deepseek-v2-lite"] = time.perf_counter() - t0
    log(f"[{time.perf_counter() - T0:.0f} s] deepseek-v2-lite served and checked")

    # (l) T1+T2 on qwen1.5-0.5b: chunked on (a)'s arena, then static
    cfg_q = dataclasses.replace(served_config(T), num_blocks=DCPQ_DEPTH)
    params_q = init_params(cfg_q, SEED, DEVICE)
    what = "decomposed_cpq"
    t0 = time.perf_counter()
    eng = T.ContinuousServeEngine(cfg_q, params_q, rt=T.AttentionRuntime(mode=what),
                                  serving=T.ServingCfg(num_slots=8, page_size=16, num_pages=513,
                                                       max_blocks_per_slot=64), device=DEVICE)
    run = make_requests(T, cfg_q.vocab_size)
    results, stats, ticks, wall, counts = serve_counted(eng, T, run, counted, fa_routes, routed)
    check_finished(results, run, what)
    check(stats["chunked_prefill"] and stats["cache_mode"] == what, f"{what}: {stats}")
    check_counts(what, counts, {})   # T1+T2 has no kernel in the reference
    serves[what] = serve_metrics(stats, ticks, wall, what)
    serves[what]["launches"] = {}
    del eng
    eng = T.ServeEngine(cfg_q, params_q, rt=T.AttentionRuntime(mode=what), device=DEVICE)
    out, stats, timer, wall, counts = serve_static(eng, T, M, static_prompts(cfg_q.vocab_size),
                                                   n_new, {}, counted, fa_routes)
    check(out.shape == (8, n_new), f"static {what}: {out.shape}")
    check_counts(f"static {what}", counts, {"flash_attention": cfg_q.num_layers,
                                            "flash_attention/prompt": cfg_q.num_layers})
    serves[f"static {what}"] = static_metrics(out, stats, timer, wall, what)
    serves[f"static {what}"]["launches"] = {k: n for k, n in counts.items() if n}
    del eng, timer, params_q
    torch.cuda.empty_cache()
    new_s[what] = time.perf_counter() - t0

    # (m) deepseek-moe-16b: attention with MoE MLPs, at MOE_DEPTH layers
    cfg_m = deepseek_config(T, "deepseek-moe-16b", MOE_DEPTH - 1)
    what = f"deepseek-moe-16b {MOE_DEPTH} layers"
    t0 = time.perf_counter()
    params_m = init_params(cfg_m, SEED, DEVICE)
    eng = T.ContinuousServeEngine(cfg_m, params_m, serving=T.ServingCfg(
        num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64), device=DEVICE)
    run = make_requests(T, cfg_m.vocab_size)
    results, stats, ticks, wall, counts = serve_counted(eng, T, run, counted, fa_routes, routed)
    check_finished(results, run, what)
    check(not stats["chunked_prefill"], f"{what}: a MoE stack admitted in chunks")
    check_counts(what, counts, {"flash_attention": MOE_DEPTH * stats["admitted"],
                                "flash_attention/prompt": MOE_DEPTH * stats["admitted"],
                                "paged_decode": MOE_DEPTH * stats["decode_steps"]})
    serves[what] = serve_metrics(stats, ticks, wall, what)
    serves[what].update(launches={k: n for k, n in counts.items() if n},
                        routes=check_routes(what, {"paged_decode": routed["paged_decode"]},
                                            counts))
    log(f"serve {what}: launches {serves[what]['launches']}")
    del eng
    new_s[what] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params_p = head_layers(params_m, cfg_m, MOE_DEPTH)
    del params_m
    torch.cuda.empty_cache()
    report["parity"]["deepseek-moe-16b"] = moe_parity(
        T, M, moe, dataclasses.replace(cfg_m, dtype="float32"), params_p,
        make_requests(T, cfg_m.vocab_size), "deepseek-moe-16b dense", "dense")
    del params_p
    torch.cuda.empty_cache()
    new_s["parity deepseek-moe-16b"] = time.perf_counter() - t0
    report["deepseek_phase_s"] = new_s
    log(f"[{time.perf_counter() - T0:.0f} s] phase 6 in {time.perf_counter() - t_all:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in new_s.items()))


# ------------------------------------------ phase 7: the recurrent stacks

RECURRENT_SERVING = dict(num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64,
                         prefill_chunk=16)  # (a)'s arena and chunks: admitted one-shot all the same
JAMBA_DEPTH = 5             # layers of serve (o): the first five of Jamba's block of eight
JAMBA_PARITY_EXPERTS = 8    # routed experts (of 16) of (o)'s float32 parity, top-2 kept
JAMBA_SWEPT = {             # phase 3's cases at jamba's attention (64 heads over 8, Dh 128)
    "paged_decode": "bfloat16 served rows KV=8 G=8 Dh=128",
    "flash_attention_prompt": "bfloat16 B=8 T=512 S=512 H=64 KV=8 D=128 causal=True",
    "flash_attention": "bfloat16 B=8 T=1 S=575 H=64 KV=8 D=128 causal=False"}


def xlstm_config(T):
    """xlstm-125m at its published widths, nothing cut: 12 layers (2 x [5
    mLSTM, 1 sLSTM]), d_model 768, 4 heads, proj_factor 2, vocab 50304."""
    cfg = T.ARCHS["xlstm-125m"]
    x = cfg.xlstm
    check(cfg.num_layers == 12 and cfg.d_model == 768 and cfg.num_heads == 4
          and cfg.vocab_size == 50304 and x.proj_factor == 2.0 and x.chunk == 256
          and x.conv_kernel == 4 and cfg.norm == "layernorm" and not cfg.tie_embeddings,
          "xlstm-125m: not the published widths")
    return cfg


def jamba_config(T):
    """jamba-1.5-large-398b at its published widths, its depth cut to the
    first JAMBA_DEPTH layers of its block of eight (mamba + dense, mamba +
    moe, mamba + dense, mamba + moe, attn + dense) as a prefix with no
    blocks: one block is 90.5 GB in bf16, more than the card holds."""
    cfg = T.ARCHS["jamba-1.5-large-398b"]
    m, e = cfg.mamba, cfg.moe
    check(cfg.d_model == 8192 and cfg.num_heads == 64 and cfg.num_kv_heads == 8
          and cfg.head_dim == 128 and cfg.d_ff == 24576 and cfg.vocab_size == 65536
          and (m.d_state, m.d_conv, m.expand) == (16, 4, 2) and e.num_experts == 16
          and e.top_k == 2 and e.d_ff_expert == 24576, "jamba: not the published widths")
    return dataclasses.replace(cfg, prefix_pattern=cfg.block_pattern[:JAMBA_DEPTH],
                               num_blocks=0)


def slot_state_bytes(cfg) -> int:
    """One slot's recurrent state over the stack, by the arithmetic of its
    shapes: Mamba the conv tail (d_conv - 1 inputs of d_in, model dtype) and
    the float32 SSM state (d_in x d_state); mLSTM C (H x dh x dh), n and m
    in float32 and the conv tail; sLSTM four float32 vectors of d_model."""
    elt = torch.empty((), dtype=cfg.param_dtype).element_size()
    total = 0
    for mixer, _ in cfg.layer_kinds:
        if mixer == "mamba":
            d_in = cfg.mamba.expand * cfg.d_model
            total += (cfg.mamba.d_conv - 1) * d_in * elt + d_in * cfg.mamba.d_state * 4
        elif mixer == "mlstm":
            d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
            H, dh = cfg.num_heads, d_in // cfg.num_heads
            total += (H * dh * dh + H * dh + H) * 4 + (cfg.xlstm.conv_kernel - 1) * d_in * elt
        elif mixer == "slstm":
            total += 4 * cfg.d_model * 4
    return total


def check_oneshot(what: str, stats: dict, n: int) -> None:
    """A recurrent stack asked for chunks is admitted one-shot, every request
    once, sharing and speculation off."""
    check(not stats["chunked_prefill"] and stats["prefill_chunks"] == 0
          and stats["admitted"] == n and not stats["prefix_sharing"] and not stats["spec_on"],
          f"{what}: chunked {stats['chunked_prefill']}, {stats['prefill_chunks']} chunks, "
          f"{stats['admitted']} admissions of {n}")


def device_parity(T, M, cfg, params, what: str) -> dict:
    """The same port code in float32 (TF32 off) on the card and on the CPU,
    on 2 of the 8 requests (the shortest and the longest prompt) through
    ContinuousServeEngine: each admission's prefill logits and the first
    decode step's within LOGIT_TOL, then the greedy streams identical but
    for a first divergence where the CPU's top-2 logit gap is below
    ARGMAX_GAP."""
    from repro_torch.params import to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    serving = T.ServingCfg(num_slots=2, page_size=16, num_pages=80, max_blocks_per_slot=64)
    pre, dec = M.prefill, M.decode_step_rows
    got, streams, gaps = {}, {}, {}
    for dev in (DEVICE, "cpu"):
        eng = T.ContinuousServeEngine(cfg, to_device(params, dev), serving=serving, device=dev)
        eng.reset(T.GenerationConfig())
        for r in make_requests(T, cfg.vocab_size)[:2]:
            eng.add_request(r)
        seen = {"prefill": [], "decode": []}

        def keep_pre(*a, seen=seen, **kw):
            out = pre(*a, **kw)
            seen["prefill"].append(out[0].cpu())
            return out

        def keep_dec(*a, seen=seen):
            out = dec(*a)
            seen["decode"].append(out[0].cpu())
            return out

        M.prefill, M.decode_step_rows = keep_pre, keep_dec
        try:
            step = gather_gaps(M, eng, gaps) if dev == "cpu" else eng.step
            while eng.has_unfinished():
                step()
        finally:
            M.prefill, M.decode_step_rows = pre, dec
        got[dev] = (torch.cat(seen["prefill"][:2]), seen["decode"][0])
        streams[dev] = {rid: res["tokens"] for rid, res in eng.results().items()}
        del eng
    out = {}
    check_logits(f"{what} card vs CPU", (got[DEVICE], got["cpu"]), out)
    out["streams_identical"] = compare_streams(
        f"{what} card vs CPU", {True: streams[DEVICE], False: streams["cpu"]}, gaps,
        {r.rid: r.max_new_tokens for r in make_requests(T, cfg.vocab_size)[:2]},
        names=("card", "CPU"))
    return out


def teacher_forced(T, M, cfg, params, what: str, n_new: int = 64) -> dict:
    """The whole stack in float32 (TF32 off), the card's continuous decode
    against the CPU's static one, one step at a time from the CPU's own
    state: request i of 2 (the shortest and the longest prompt) is prefilled
    on the CPU and decoded greedily there (``decode_step``); before every
    step the CPU's state is written into row i of a 2-slot state tree on the
    card (``init_paged_caches``, ``pack_prefill_caches``), which takes the
    same step through ``decode_step_rows`` as ContinuousServeEngine does.
    Its logits must be within LOGIT_TOL of the CPU's, its argmax the CPU's
    but where the CPU's top-2 gap is below ARGMAX_GAP (counted), and the
    state it wrote in place into row i the CPU's new state within LOGIT_TOL
    (atol = rtol), every leaf of every layer. Also reported, no gate: the
    prefill logits of the card's own prefill against the CPU's, and the
    CPU's against its own prefill of embeddings scaled by 1 + 1e-7 (how far
    a last-ulp difference carries)."""
    from repro_torch.params import to_device
    from repro_torch.serving.paged_cache import RowState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rt = cfg.attention
    cpu = to_device(params, "cpu")
    nudged = {**cpu, "embed": {**cpu["embed"], "tok": cpu["embed"]["tok"] * (1 + 1e-7)}}
    serving = T.ServingCfg(num_slots=2, page_size=16, num_pages=80, max_blocks_per_slot=64)
    card = M.init_paged_caches(cfg, rt, serving, DEVICE)
    out = {"decode_steps": 0, "argmax_excused": 0, "logits_max_abs_diff": 0.0,
           "state_max_abs_diff": 0.0,
           "free_prefill_logits_max_abs_diff": [], "cpu_nudged_prefill_logits_max_abs_diff": []}
    for slot, r in enumerate(make_requests(T, cfg.vocab_size)[:2]):
        S = len(r.prompt)
        tok = torch.tensor(r.prompt[None])

        def prefill(p, dev):
            caches = M.init_caches(cfg, rt, 1, S + n_new, dev)
            return M.prefill(cfg, rt, p, {"tokens": tok.to(dev)}, caches)

        logits, caches = prefill(cpu, "cpu")
        free = prefill(params, DEVICE)[0].cpu()
        out["free_prefill_logits_max_abs_diff"].append((free - logits).abs().max().item())
        out["cpu_nudged_prefill_logits_max_abs_diff"].append(
            (prefill(nudged, "cpu")[0] - logits).abs().max().item())
        for t in range(n_new):
            nxt = logits.argmax(-1).to(torch.int32)[:, None]
            M.pack_prefill_caches(cfg, rt, card, caches, None, slot)
            tokens = torch.zeros((2, 1), dtype=torch.int32)
            tokens[slot] = nxt[0]
            rows = RowState(lengths=torch.full((2,), S + t, dtype=torch.int32, device=DEVICE),
                            block_table=torch.zeros((2, 64), dtype=torch.int32, device=DEVICE),
                            active=torch.arange(2, device=DEVICE) == slot,
                            tier=torch.zeros(2, dtype=torch.int32, device=DEVICE))
            got, _ = M.decode_step_rows(cfg, rt, params, tokens.to(DEVICE), rows, card)
            logits, caches = M.decode_step(cfg, rt, cpu, nxt, S + t, caches)
            got = got[slot:slot + 1].cpu()
            err = (got - logits).abs().max().item()
            out["logits_max_abs_diff"] = max(out["logits_max_abs_diff"], err)
            check(torch.allclose(got, logits, atol=LOGIT_TOL, rtol=LOGIT_TOL),
                  f"parity {what}: request {r.rid} step {t}: logits differ by {err:.3e}")
            if not torch.equal(got.argmax(-1), logits.argmax(-1)):
                gap = top2_gap(logits).item()
                check(gap < ARGMAX_GAP, f"parity {what}: request {r.rid} step {t}: argmax "
                      f"differs at a resolvable gap {gap:.3e}")
                out["argmax_excused"] += 1
            for i, (dst, src) in enumerate(zip(M.per_layer(cfg, card), M.per_layer(cfg, caches))):
                for name, d, c in zip(src._fields, dst, src):
                    d = d[slot].cpu()
                    err = (d - c[0]).abs().max().item()
                    out["state_max_abs_diff"] = max(out["state_max_abs_diff"], err)
                    check(torch.allclose(d, c[0], atol=LOGIT_TOL, rtol=LOGIT_TOL),
                          f"parity {what}: request {r.rid} step {t}: layer {i} state "
                          f"{name} differs by {err:.3e}")
            out["decode_steps"] += 1
    log(f"parity {what}: {out['decode_steps']} continuous decode steps (decode_step_rows, "
        f"request i in row i of 2) from the CPU's state, logits within "
        f"{out['logits_max_abs_diff']:.3e} and the states written in place within "
        f"{out['state_max_abs_diff']:.3e} (atol=rtol={LOGIT_TOL}), "
        f"{out['argmax_excused']} argmax near ties excused; free-running prefill logits "
        f"card vs CPU {out['free_prefill_logits_max_abs_diff']}, CPU vs its embeddings "
        f"scaled by 1 + 1e-7 {out['cpu_nudged_prefill_logits_max_abs_diff']} (no gate)")
    return out


def cut_float(tree, experts: int):
    """A parameter tree in float32, in place, each MoE layer's routed experts
    cut to the first ``experts`` (its router's columns too): every leaf is
    replaced by its copy as the copy is made, so the bf16 model and the
    float32 one are never both whole on the card."""
    if isinstance(tree, list):
        for t in tree:
            cut_float(t, experts)
        return tree
    moe = "router" in tree
    for k, v in tree.items():
        if isinstance(v, (dict, list)):
            cut_float(v, experts)
        elif moe and k == "router":
            tree[k] = v[:, :experts].float()
        elif moe and k in ("w_gate", "w_up", "w_down"):
            tree[k] = v[:experts].float()
        else:
            tree[k] = v.float()
    return tree


def serve_recurrent(T, M, ops, fa_ops, counted: list, routed: dict, fa_routes: dict,
                    serves: dict, report: dict, timing: dict, new_s: dict) -> None:
    """Phase 7: (n) xlstm-125m at its published widths, bf16, on
    ContinuousServeEngine over (a)'s arena and traffic, asked for chunks of
    16 but admitted one-shot at the exact prompt length (no attention
    kernel), and on the static ServeEngine (8 x 512, 64 new); its float32
    parity, card against CPU, on 2 of the 8 requests: the whole stack step
    by step from the CPU's state, the card's continuous decode against the
    CPU's static one (``teacher_forced``), its mLSTM layers
    alone free-running (``device_parity``). (o) jamba at its
    published widths cut to its first JAMBA_DEPTH layers, dense, one-shot
    (B8's prompt route once an admission, B1's ring once a decode tick, B1
    timed at the served shape) and static (B8's prompt route once, its
    single-query route once a step, both timed); its float32 parity,
    kernels on and off, with the routed experts cut to JAMBA_PARITY_EXPERTS
    (the bf16 model freed first). Each serve's launch counts are set to 0
    just before it and read just after."""
    from repro_torch.models import moe
    from repro_torch.params import init_params

    t_all = time.perf_counter()
    # (n) xlstm-125m
    cfg = xlstm_config(T)
    what = "xlstm-125m"
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, DEVICE)
    log(f"{what}: {device_bytes(params) / 1e9:.3f} GB of bf16 weights on the card")
    n_slots = RECURRENT_SERVING["num_slots"]
    per_slot = slot_state_bytes(cfg)
    eng = T.ContinuousServeEngine(cfg, params, serving=T.ServingCfg(**RECURRENT_SERVING),
                                  device=DEVICE)
    run = make_requests(T, cfg.vocab_size)
    results, stats, ticks, wall, counts = serve_counted(eng, T, run, counted, fa_routes, routed)
    check_finished(results, run, what)
    check_oneshot(what, stats, len(run))
    check_counts(what, counts, {})   # attention-free: no kernel
    check(stats["arena_bytes_total"] == n_slots * per_slot and stats["bytes_per_token_layer"] == 0,
          f"{what}: arena {stats['arena_bytes_total']} bytes, want {n_slots} x {per_slot}")
    serves[what] = serve_metrics(stats, ticks, wall, what)
    serves[what].update(launches={}, state_bytes_per_slot=per_slot)
    log(f"serve {what}: slot state {per_slot} bytes a slot ({n_slots} slots); no kernel "
        f"launched")
    del eng
    new_s[what] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = T.ServeEngine(cfg, params, device=DEVICE)
    out, stats, timer, wall, counts = serve_static(eng, T, M, static_prompts(cfg.vocab_size), 64,
                                                   {}, counted, fa_routes)
    check(out.shape == (8, 64) and stats["decode_steps"] == 63, f"static {what}: {out.shape}")
    check_counts(f"static {what}", counts, {})
    serves[f"static {what}"] = static_metrics(out, stats, timer, wall, what)
    serves[f"static {what}"]["launches"] = {}
    check(serves[f"static {what}"]["arena_bytes"] == 8 * per_slot, f"static {what}: arena")
    del eng, timer
    new_s[f"static {what}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = _tree_float(params)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    # the sLSTM's recurrence is chaotic at these random weights (the
    # reference's fan-in init draws r with std 0.5 on 192-wide heads): a
    # last-ulp difference grows to O(1) over a prompt. So the whole stack is
    # held step by step from the CPU's state, and the stack of its 10 mLSTM
    # layers alone free-running through the engines
    report["parity"][what] = teacher_forced(T, M, cfg32, params, what)
    mlstm = [i for i, (m, _) in enumerate(cfg.block_pattern) if m == "mlstm"]
    report["parity"][f"{what} mLSTM layers"] = device_parity(
        T, M, dataclasses.replace(cfg32, block_pattern=tuple(cfg.block_pattern[i] for i in mlstm)),
        {**params, "blocks": [params["blocks"][i] for i in mlstm]}, f"{what} mLSTM layers")
    del params
    torch.cuda.empty_cache()
    new_s[f"parity {what}"] = time.perf_counter() - t0
    log(f"[{time.perf_counter() - T0:.0f} s] {what} served and checked")

    # (o) jamba, the first JAMBA_DEPTH layers
    cfg = jamba_config(T)
    what = f"jamba {JAMBA_DEPTH} layers"
    n_attn = sum(m == "attn" for m, _ in cfg.layer_kinds)
    scale = cfg.head_dim ** -0.5
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, DEVICE)
    torch.cuda.synchronize()
    log(f"{what}: {device_bytes(params) / 1e9:.2f} GB of bf16 weights on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    eng = T.ContinuousServeEngine(cfg, params, serving=T.ServingCfg(**RECURRENT_SERVING),
                                  device=DEVICE)
    rec = Recorder(ops.paged_decode, n_attn, 10, lambda q, k, v, *r: (k, v),
                   lambda q, k, v, bt, ln, s: (q.clone(), bt.clone(), ln.clone()))
    ops.paged_decode = rec
    run = make_requests(T, cfg.vocab_size)
    try:
        results, stats, ticks, wall, counts = serve_counted(eng, T, run, counted, fa_routes,
                                                            routed)
    finally:
        ops.paged_decode = rec.fn
    check_finished(results, run, what)
    check_oneshot(what, stats, len(run))
    check_counts(what, counts, {"flash_attention": n_attn * stats["admitted"],
                                "flash_attention/prompt": n_attn * stats["admitted"],
                                "paged_decode": n_attn * stats["decode_steps"]})
    per_slot = slot_state_bytes(cfg)
    serves[what] = serve_metrics(stats, ticks, wall, what)
    serves[what].update(
        launches={k: n for k, n in counts.items() if n}, state_bytes_per_slot=per_slot,
        attention_arena_bytes=stats["arena_bytes_total"] - n_slots * per_slot,
        routes=check_routes(what, {"paged_decode": routed["paged_decode"]}, counts))
    log(f"serve {what}: launches {serves[what]['launches']}; slot state {per_slot} bytes a "
        f"slot, attention arena {serves[what]['attention_arena_bytes']} bytes")
    del eng
    timing["paged_decode"] = time_kernel(rec, decode_case(ops, scale))
    log_timing(f"paged_decode at {what}", timing["paged_decode"], counts["paged_decode"],
               counts["paged_decode"] / stats["decode_steps"])
    del rec
    new_s[what] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = T.ServeEngine(cfg, params, device=DEVICE)
    frec = FlashRecorder(fa_ops.flash_attention, n_attn)
    out, stats, timer, wall, counts = serve_static(
        eng, T, M, static_prompts(cfg.vocab_size), 64, {"flash_attention": (fa_ops, frec)},
        counted, fa_routes)
    steps = stats["decode_steps"]
    check(out.shape == (8, 64) and steps == 63, f"static {what}: {out.shape}")
    check_counts(f"static {what}", counts, {"flash_attention": n_attn * (1 + steps),
                                            "flash_attention/prompt": n_attn,
                                            "flash_attention/decode": n_attn * steps})
    serves[f"static {what}"] = static_metrics(out, stats, timer, wall, what)
    serves[f"static {what}"]["launches"] = {k: n for k, n in counts.items() if n}
    del eng, timer
    for name, r, case, n in (
            ("flash_attention_prompt", frec.pre, flash_prefill_case(fa_ops, scale), 1),
            ("flash_attention", frec.dec, flash_decode_case(fa_ops, scale), steps)):
        timing[name] = time_kernel(r, case)
        log_timing(f"{name} at static {what}", timing[name], n_attn * n, n_attn,
                   "prefill" if n == 1 else "step")
    del frec
    new_s[f"static {what}"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    E = JAMBA_PARITY_EXPERTS
    params = cut_float(params, E)
    torch.cuda.empty_cache()
    cfg_p = dataclasses.replace(cfg, dtype="float32",
                                moe=dataclasses.replace(cfg.moe, num_experts=E))
    log(f"{what}: {device_bytes(params) / 1e9:.2f} GB in float32 with {E} routed experts")
    report["parity"]["jamba"] = moe_parity(T, M, moe, cfg_p, params,
                                           make_requests(T, cfg.vocab_size),
                                           f"{what} dense", "dense")
    del params
    torch.cuda.empty_cache()
    new_s[f"parity {what}"] = time.perf_counter() - t0
    report["recurrent_phase_s"] = new_s
    report["recurrent_timing"] = timing
    log(f"[{time.perf_counter() - T0:.0f} s] phase 7 in {time.perf_counter() - t_all:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in new_s.items()))


# ------------------------------------------------------ phase 8: multimodal

MUSICGEN_MODES = ("dense", "decomposed", "cpq", "retrieval")
STEP_KERNEL = {"dense": "flash_attention", "decomposed": "decomposed_decode",
               "cpq": "cpq_decode", "retrieval": "proxy_scores"}
XATTN_GATE = 1.0            # (p)'s cross-attention gates (the reference draws them at 0)
PATCH_MOVE = (3.0, 1.0)     # (p)'s parity repeated with the patches scaled by 3, shifted by 1
DECOMPOSED_TOL = 3e-4       # (q): T1 against dense logits, exact at absolute positions
# phase 3's cases at the shapes phase 8 times, by (kernel, shape label)
MULTIMODAL_SWEPT = {
    ("flash_attention_prompt", "llama-vision xattn"):
        "bfloat16 B=8 T=512 S=1600 H=32 KV=8 D=128 causal=False",
    ("flash_attention_prompt", "musicgen"):
        "bfloat16 B=8 T=512 S=512 H=32 KV=32 D=64 causal=True",
    ("flash_attention", "llama-vision xattn"):
        "bfloat16 B=8 T=1 S=1600 H=32 KV=8 D=128 causal=False",
    ("flash_attention", "musicgen"): "bfloat16 B=8 T=1 S=575 H=32 KV=32 D=64 causal=False",
    ("decomposed_decode", "musicgen"):
        "bfloat16 B=8 N=576 H=32 Dm=2048 kv_r=32 Rr=0 length=575",
    ("cpq_decode", "musicgen"):
        "float32 q=bfloat16 B=8 N=576 KV=32 G=1 Dh=64 bits=4 length=575 round=True",
    ("paged_proxy_scores", "musicgen"): "float32 KV=32 G=1 Dp=64",
}


def vision_config(T):
    """llama-3.2-vision-11b at its published widths, nothing cut: 40 layers,
    8 blocks of (attn, attn, attn, xattn, attn), d_model 4096, 32 heads over
    8 of 128, SwiGLU d_ff 14336, vocab 128256, untied, rope theta 500000,
    1600 patch tokens."""
    cfg = T.ARCHS["llama-3.2-vision-11b"]
    check(cfg.num_layers == 40 and cfg.num_blocks == 8 and cfg.d_model == 4096
          and [m for m, _ in cfg.block_pattern] == ["attn"] * 3 + ["xattn", "attn"]
          and (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (32, 8, 128)
          and cfg.d_ff == 14336 and cfg.mlp_act == "swiglu" and cfg.vocab_size == 128256
          and not cfg.tie_embeddings and cfg.rope_theta == 500000.0
          and cfg.input_kind == "text+patches" and cfg.num_patch_tokens == 1600,
          "llama-3.2-vision-11b: not the published widths")
    return cfg


def musicgen_config(T):
    """musicgen-large at its published widths, nothing cut: 48 layers,
    d_model 2048, 32 heads of 64 (MHA), GELU d_ff 8192, layernorm, absolute
    positions, vocab 2048, audio frames in."""
    cfg = T.ARCHS["musicgen-large"]
    check(cfg.num_layers == 48 and cfg.d_model == 2048
          and (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (32, 32, 64)
          and cfg.d_ff == 8192 and cfg.mlp_act == "gelu" and cfg.norm == "layernorm"
          and cfg.pos_embedding == "absolute" and cfg.vocab_size == 2048
          and cfg.input_kind == "audio_frames", "musicgen-large: not the published widths")
    return cfg


def multimodal_batch(cfg) -> dict:
    """A static serve's batch of 8 rows, float32 on the card, drawn as the
    reference's tests/test_models_smoke.py draws them: musicgen 512 frames
    of 0.3 N(0, 1) a row; llama-vision 512 seeded tokens and 1600 patches
    of N(0, 1) a row."""
    gen = torch.Generator(device=DEVICE).manual_seed(SEED + 2)
    if cfg.input_kind == "audio_frames":
        return {"frames": 0.3 * torch.randn((8, 512, cfg.d_model), generator=gen, device=DEVICE)}
    return {**static_prompts(cfg.vocab_size),
            "patches": torch.randn((8, cfg.num_patch_tokens, cfg.d_model), generator=gen,
                                   device=DEVICE)}


def set_gates(M, cfg, params, value: float) -> int:
    """Every cross-attention gate of ``params`` set to ``value``, in place.
    Returns how many."""
    n = 0
    for (mixer, _), p in zip(cfg.layer_kinds, M.per_layer(cfg, params)):
        if mixer == "xattn":
            p["mixer"]["gate"].fill_(value)
            n += 1
    return n


class XattnRecorder(StandIn):
    """B8's Recorder at serve (p): the self-attention layers' calls as a
    FlashRecorder samples them (``own``), the cross-attention layers' apart:
    their non-causal prompt over the patch keys (``xpre``) and their decode
    token over every patch key (``xdec``, told from a self-attention decode
    by its arena of ``n_patches`` keys)."""

    def __init__(self, fn, n_self: int, n_cross: int, n_patches: int):
        self.fn, self.n_patches = fn, n_patches
        self.own = FlashRecorder(fn, n_self)
        self.xpre = Recorder(fn, n_cross, 1, lambda q, k, v, *r: (k, v),
                             lambda q, k, v, *r: (q.clone(),))
        self.xdec = Recorder(fn, n_cross, 10, lambda q, k, v, *r: (arena_of(k), arena_of(v)),
                             lambda q, k, v, *r: (q.clone(), k.shape[1]))

    def __call__(self, q, k, v, scale, causal=True):
        if q.shape[1] > 1 and not causal:
            return self.xpre(q, k, v, scale, causal)
        if q.shape[1] == 1 and arena_of(k).shape[1] == self.n_patches:
            return self.xdec(q, k, v, scale, causal)
        return self.own(q, k, v, scale, causal)


def n_params(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    return sum(n_params(t) for t in (tree.values() if isinstance(tree, dict) else tree))


def serve_multimodal(T, M, kops: dict, counted: list, t3_cfg, serves: dict, report: dict,
                     timing: dict, new_s: dict) -> None:
    """Phase 8: (p) llama-3.2-vision-11b and (q) musicgen-large at their
    published widths, nothing cut, random bf16 weights from a seed, on the
    static ServeEngine (8 rows of 512, 64 new). (p): every cross-attention
    gate set to XATTN_GATE, each row its own patches; mode dense: B8's
    prompt route 40 times a prefill (32 causal, 8 non-causal over 1600 patch
    keys) and its decode route 40 times a step (8 over the patch keys).
    (q): audio frames in, modes dense (B8), decomposed (B9, every launch on
    its sweep: d_model 2048), cpq (B10) and retrieval (B7's contiguous
    form, top_k 256). The new shapes timed (``timing[kernel][shape]``); then
    each model's f32 parity over its first PARITY_DEPTH layers (the bf16
    model freed first): kernels on against off as phase 5 holds them, (p)
    again with its patches moved (PATCH_MOVE) and how far its logits moved,
    and (q)'s T1 logits against its dense ones within DECOMPOSED_TOL. Each
    serve's launch counts are set to 0 just before it and read just
    after."""
    from repro_torch.params import init_params

    fa_ops, t1_ops = kops["flash_attention"], kops["decomposed_decode"]
    cpq_ops, t3_ops = kops["cpq_decode"], kops["paged_proxy_scores"]
    routes = fa_ops.ROUTE_LAUNCHES
    t_all = time.perf_counter()

    # (p) llama-3.2-vision-11b
    cfg = vision_config(T)
    what = "llama-3.2-vision-11b"
    L = cfg.num_layers
    n_cross = sum(m == "xattn" for m, _ in cfg.layer_kinds)
    n_self = L - n_cross
    scale = cfg.head_dim ** -0.5
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, DEVICE)
    gates = set_gates(M, cfg, params, XATTN_GATE)
    torch.cuda.synchronize()
    log(f"{what}: {n_params(params) / 1e9:.3f} B parameters, {device_bytes(params) / 1e9:.2f} "
        f"GB of bf16 weights on the card in {time.perf_counter() - t0:.1f} s; all {gates} "
        f"cross-attention gates set to {XATTN_GATE} (the reference draws them at 0, where "
        "the layers add nothing)")
    batch = multimodal_batch(cfg)
    eng = T.ServeEngine(cfg, params, device=DEVICE)
    rec = XattnRecorder(fa_ops.flash_attention, n_self, n_cross, cfg.num_patch_tokens)
    out, stats, timer, wall, counts = serve_static(eng, T, M, batch, 64,
                                                   {"flash_attention": (fa_ops, rec)}, counted,
                                                   routes)
    steps = stats["decode_steps"]
    check(out.shape == (8, 64) and steps == 63, f"static {what}: {out.shape}")
    check_counts(f"static {what}", counts, {"flash_attention": L * (1 + steps),
                                            "flash_attention/prompt": L,
                                            "flash_attention/decode": L * steps})
    calls = {"causal prompt": rec.own.pre.calls, "xattn prompt": rec.xpre.calls,
             "decode": rec.own.dec.calls, "xattn decode": rec.xdec.calls}
    want = {"causal prompt": n_self, "xattn prompt": n_cross, "decode": n_self * steps,
            "xattn decode": n_cross * steps}
    check(calls == want, f"static {what}: B8 calls {calls}, want {want}")
    kv = 2 * 2 * cfg.num_kv_heads * cfg.head_dim       # K and V, bf16, a token
    arena = {"self-attention": n_self * 8 * (512 + 64) * kv,
             "cross-attention": n_cross * 8 * cfg.num_patch_tokens * kv}
    m = serves[f"static {what}"] = static_metrics(out, stats, timer, wall, what)
    m.update(launches={k: n for k, n in counts.items() if n}, b8_calls=calls,
             arena_by_kind=arena)
    check(m["arena_bytes"] == sum(arena.values()),
          f"static {what}: arena {m['arena_bytes']} bytes, want {arena}")
    log(f"serve static {what}: B8 calls {calls}; arena {arena}")
    del eng, timer
    for name, r, case, n, unit in (
            ("flash_attention_prompt", rec.xpre, flash_prefill_case(fa_ops, scale, False), 1,
             "prefill"),
            ("flash_attention", rec.xdec, flash_decode_case(fa_ops, scale), steps, "step")):
        t = timing.setdefault(name, {})["llama-vision xattn"] = time_kernel(r, case)
        log_timing(f"{name} at {what}'s cross-attention", t, n_cross * n, n_cross, unit)
    del rec
    new_s[what] = time.perf_counter() - t0

    t0 = time.perf_counter()
    depth = PARITY_DEPTH  # the first layers as a prefix: 3 self-attention and the xattn
    cfg_p = dataclasses.replace(cfg, dtype="float32", prefix_pattern=cfg.block_pattern[:depth],
                                num_blocks=0)
    check([m for m, _ in cfg_p.layer_kinds].count("xattn") == 1, f"{what}: parity depth")
    head = {**params, "prefix": [params["blocks"][j][0] for j in range(depth)],
            "blocks": [[] for _ in cfg.block_pattern]}
    del params
    params = _tree_float(head)
    del head
    torch.cuda.empty_cache()
    par = report["parity"]
    par[what] = static_parity(T, M, cfg_p, params, batch, "dense", 64, what=f"static {what}")
    moved = {**batch, "patches": PATCH_MOVE[0] * batch["patches"] + PATCH_MOVE[1]}
    par[f"{what} patches moved"] = static_parity(T, M, cfg_p, params, moved, "dense", 64,
                                                 what=f"static {what} patches moved")
    rt = T.AttentionRuntime()
    a, b = (static_first_logits(M, cfg_p, rt, params, x) for x in (batch, moved))
    shift = {"prefill": (a[0] - b[0]).abs().max().item(),
             "first_decode": (a[1] - b[1]).abs().max().item()}
    par[what]["logits_moved_by_patches"] = shift
    log(f"parity {what}: patches x {PATCH_MOVE[0]} + {PATCH_MOVE[1]} move the logits by "
        f"{shift['prefill']:.3e} (prefill) and {shift['first_decode']:.3e} (first decode): "
        "the cross-attention is live")
    check(min(shift.values()) > 10 * LOGIT_TOL, f"{what}: the patches do not move the logits")
    del params, batch, moved
    torch.cuda.empty_cache()
    new_s[f"parity {what}"] = time.perf_counter() - t0
    log(f"[{time.perf_counter() - T0:.0f} s] {what} served and checked")

    # (q) musicgen-large
    cfg = musicgen_config(T)
    what = "musicgen-large"
    L = cfg.num_layers
    scale = cfg.head_dim ** -0.5
    t0 = time.perf_counter()
    params = init_params(cfg, SEED, DEVICE)
    torch.cuda.synchronize()
    log(f"{what}: {n_params(params) / 1e9:.3f} B parameters, {device_bytes(params) / 1e9:.2f} "
        f"GB of bf16 weights on the card")
    batch = multimodal_batch(cfg)
    rts = {mode: T.AttentionRuntime(mode=mode) for mode in MUSICGEN_MODES}
    rts["retrieval"] = T.AttentionRuntime(mode="retrieval", retrieval=t3_cfg)
    kv = 2 * cfg.num_kv_heads * cfg.head_dim           # K or V, bf16, a token
    arena_want = {"dense": L * 8 * (512 + 64) * 2 * kv,
                  "decomposed": L * 8 * (512 + 64) * 2 * cfg.d_model}
    t1_routed = {"decomposed_decode": (t1_ops.CONTIG_ROUTE_LAUNCHES, "sweep")}
    new_s[f"{what} init"] = time.perf_counter() - t0
    for mode in MUSICGEN_MODES:
        t0 = time.perf_counter()
        eng = T.ServeEngine(cfg, params, rt=rts[mode], device=DEVICE)
        recs = {"dense": lambda: {"flash_attention": (fa_ops, FlashRecorder(
                    fa_ops.flash_attention, L))},
                "decomposed": lambda: {"decomposed_decode": (t1_ops, t1c_recorder(t1_ops, L))},
                "cpq": lambda: {"cpq_decode": (cpq_ops, cpqc_recorder(cpq_ops, L))},
                "retrieval": lambda: {"proxy_scores_q": (t3_ops, t3c_recorder(t3_ops, L))}}[mode]()
        zero_routes(t1_routed)
        out, stats, timer, wall, counts = serve_static(eng, T, M, batch, 64, recs, counted,
                                                       routes)
        steps = stats["decode_steps"]
        tag = f"static {what} {mode}"
        check(out.shape == (8, 64) and steps == 63, f"{tag}: {out.shape}")
        want = {"flash_attention": L * (1 + steps * (mode == "dense")),
                "flash_attention/prompt": L}
        want[COUNT_KEY.get(STEP_KERNEL[mode], STEP_KERNEL[mode])] = L * steps
        check_counts(tag, counts, want)
        m = serves[tag] = static_metrics(out, stats, timer, wall, f"{what} {mode}")
        m["launches"] = {k: n for k, n in counts.items() if n}
        if mode == "decomposed":  # d_model 2048: every B9 launch on its sweep
            m["routes"] = check_routes(tag, t1_routed, counts)
            log(f"serve {tag}: B9 routes {m['routes']['decomposed_decode']}")
        if mode in arena_want:
            check(m["arena_bytes"] == arena_want[mode],
                  f"{tag}: arena {m['arena_bytes']} bytes, want {arena_want[mode]}")
        del eng, timer
        if mode == "dense":
            frec = recs["flash_attention"][1]
            cases = (("flash_attention_prompt", frec.pre, flash_prefill_case(fa_ops, scale), 1),
                     ("flash_attention", frec.dec, flash_decode_case(fa_ops, scale), steps))
        else:
            name = STEP_KERNEL[mode]
            case = {"decomposed": t1c_decode_case(t1_ops, scale),
                    "cpq": cpqc_decode_case(cpq_ops, scale),
                    "retrieval": t3c_decode_case(t3_ops)}[mode]
            cases = (("paged_proxy_scores" if mode == "retrieval" else name,
                      next(iter(recs.values()))[1], case, steps),)
        for name, r, case, n in cases:
            t = timing.setdefault(name, {})["musicgen"] = time_kernel(r, case)
            log_timing(f"{name} at {tag}", t, L * n, L, "prefill" if n == 1 else "step")
        del recs, cases
        torch.cuda.empty_cache()
        new_s[tag] = time.perf_counter() - t0
    log(f"serve static {what}: arena bytes " + ", ".join(
        f"{mode} {serves[f'static {what} {mode}']['arena_bytes']}" for mode in MUSICGEN_MODES))

    t0 = time.perf_counter()
    depth = min(PARITY_DEPTH, cfg.num_blocks)
    cfg_p = dataclasses.replace(cfg, dtype="float32", num_blocks=depth)
    params = head_layers(params, cfg, depth)
    torch.cuda.empty_cache()
    for mode in MUSICGEN_MODES:
        report["parity"][f"static {what} {mode}"] = static_parity(
            T, M, cfg_p, params, batch, mode, 64,
            dict(retrieval=t3_cfg) if mode == "retrieval" else None, f"static {what} {mode}")
    dense, t1 = (static_first_logits(M, cfg_p, T.AttentionRuntime(mode=mode), params, batch)
                 for mode in ("dense", "decomposed"))
    gap = {"prefill": (dense[0] - t1[0]).abs().max().item(),
           "first_decode": (dense[1] - t1[1]).abs().max().item()}
    report["parity"][f"static {what} decomposed"]["against_dense"] = gap
    log(f"parity {what}: decomposed against dense logits {gap} (atol {DECOMPOSED_TOL}: T1 is "
        "exact at absolute positions)")
    check(max(gap.values()) <= DECOMPOSED_TOL, f"{what}: decomposed against dense {gap}")
    del params, batch
    torch.cuda.empty_cache()
    new_s[f"parity {what}"] = time.perf_counter() - t0
    report["multimodal_phase_s"] = new_s
    report["multimodal_timing"] = timing
    log(f"[{time.perf_counter() - T0:.0f} s] phase 8 in {time.perf_counter() - t_all:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in new_s.items()))


# ------------------------------------------------------- phase 11: the mesh

MESH_MODES = ("dense", "cpq", "decomposed", "retrieval", "tiered")
MESH_KERNELS = {  # mode -> (decode kernel, chunk kernel)
    "dense": ("paged_decode", "paged_prefill"),
    "cpq": ("paged_cpq_decode", "paged_cpq_prefill"),
    "decomposed": ("paged_decomposed_decode", "paged_decomposed_prefill"),
    "retrieval": ("paged_proxy_scores", "paged_prefill"),
}
MESH_LOGIT_TOL = 1e-5       # (v3): f32 first logits, sharded vs unsharded on the card
MESH_CPU_TOL = 1e-3         # (v3): f32 first logits, the card's sharded engine vs the CPU's
MESH_CPU_NEW = 8            # (v3): tokens of the card-vs-CPU streams (2 requests)
MESH_PARITY_MODES = ("dense", "decomposed")  # (v3): a head-split arena and a split latent
MESH_DEPTH = PARITY_DEPTH   # (v2): layers of the serves but MESH_FULL's (of 24; each
                            # mode's unsharded serve is made again at this depth)
MESH_FULL = (("dense", 2), ("decomposed", 2))  # (v2): served at all 24 layers


def mesh_devices(mp: int) -> list:
    """``mp`` shard devices: distinct cards where the machine has them, else
    the one card repeated (its shards then share it)."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(mp)] if n >= mp else [torch.device(DEVICE)] * mp


def shard_kernel_sweeps(ops, cpq_ops, t1_ops, t3_ops, errs: dict) -> None:
    """(v1): the kernels at the shapes a model shard launches them, bf16 and
    f32, on phase 3's layouts, each call on its route: B1, B2, B5 and B6 at
    qwen1.5-0.5b's 16 kv heads split 2 and 4 ways (KV 8 and 4, G 1, Dh 64);
    B3 and B4 at half its 16 query heads over the whole d_model (H 8, Dm
    1024, 8 roped keys of 32) and over the MLA latent (H 8, Dm 512, the one
    shared roped key of 64); B7 at KV 8 (float32)."""
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for KV in (8, 4):
            tag = f"{dname} mesh shard KV={KV} G=1 Dh=64"
            e_dec, e_pre = sweep(ops, dtype, KV, 1, 64)
            errs["paged_decode"][tag], errs["paged_prefill"][tag] = e_dec, e_pre
            cpq = [sweep_cpq(cpq_ops, dtype, KV, 1, 64, bits) for bits in (4, 8)]
            errs["paged_cpq_decode"][tag] = max(e for e, _ in cpq)
            errs["paged_cpq_prefill"][tag] = max(e for _, e in cpq)
            log(f"(v1) sweep {tag}: paged_decode {e_dec:.3e}, paged_prefill {e_pre:.3e}, "
                f"paged_cpq_decode {errs['paged_cpq_decode'][tag]:.3e}, paged_cpq_prefill "
                f"{errs['paged_cpq_prefill'][tag]:.3e} (bits 4 and 8; tol {TOL[dtype]})")
        for H, Dm, kv_r, Rr in ((8, 1024, 8, 32), (8, 512, 1, 64)):
            tag = f"{dname} mesh shard H={H} Dm={Dm} kv_r={kv_r} Rr={Rr}"
            e_dec, e_pre = sweep_t1(t1_ops, dtype, H, Dm, kv_r, Rr)
            errs["paged_decomposed_decode"][tag] = e_dec
            errs["paged_decomposed_prefill"][tag] = e_pre
            log(f"(v1) sweep {tag}: paged_decomposed_decode {e_dec:.3e} "
                f"({t1_ops.t1_decode_route(dtype, H, Dm, kv_r, Rr)} route), "
                f"paged_decomposed_prefill {e_pre:.3e} "
                f"({t1_ops.t1_prefill_route(dtype, Dm, Rr)} route; tol {TOL[dtype]})")
        for name in ("paged_decode", "paged_prefill", "paged_cpq_decode", "paged_cpq_prefill",
                     "paged_decomposed_decode", "paged_decomposed_prefill"):
            for tag, err in errs[name].items():
                if "mesh shard" in tag and tag.startswith(dname):
                    check(err <= TOL[dtype], f"(v1) {name} {tag}: error {err}")
    tag = "float32 mesh shard KV=8 G=1 Dp=64"
    errs["paged_proxy_scores"][tag] = sweep_t3(t3_ops, 8, 1, 64)
    log(f"(v1) sweep {tag}: paged_proxy_scores {errs['paged_proxy_scores'][tag]:.3e} "
        f"(tol {T3_REL} x max |score|)")
    for H, Dm, kv_r, Rr, mp in ((16, 1024, 16, 32, 2), (16, 1024, 16, 32, 4),
                                (16, 512, 1, 64, 2)):
        n_dec, n_pre = t1_shards_differ(t1_ops, H, Dm, kv_r, Rr, mp)
        log(f"(v1) bf16 B3, B4 over {mp} head shards of H={H} Dm={Dm} kv_r={kv_r} Rr={Rr}, "
            f"planned as the whole call: {n_dec} and {n_pre} outputs differ from the whole "
            f"call's")
        check(n_dec == n_pre == 0, f"(v1) T1 over {mp} shards: {n_dec}, {n_pre} differ")


def t1_shards_differ(t1_ops, H, Dm, kv_r, Rr, mp, page=16, nb=64, B=8, C=16):
    """(v1): B3 and B4 in bf16 over ``mp`` head shards, each launch planned
    as the whole call (``single_query.Whole``, as serving/sharded.py plans
    a shard's), against the whole call on the same inputs (sweep_t1's
    layout): the number of outputs that differ, decode and prefill."""
    from repro_torch.kernels import single_query

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    num_pages, lengths, bt = layout(rng, B, nb, page)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE).to(torch.bfloat16)

    xp, krp = randn(num_pages, page, Dm), randn(num_pages, page, kv_r, Rr)
    bt_t, len_t = torch.tensor(bt, device=DEVICE), torch.tensor(lengths, device=DEVICE)
    scale = (Dm + Rr) ** -0.5
    groups = mp if kv_r > 1 else 1               # MLA's one roped key is held whole
    offset, valid, _ = chunk_calls(int(lengths[-1]), C)[-1]
    r, qr, rc, qc = randn(B, H, Dm), randn(B, H, Rr), randn(C, H, Dm), randn(C, H, Rr)

    def calls(i):                                # shard i's heads; None: every head
        hs = gs = slice(None)
        whole = single_query.WHOLE
        if i is not None:
            whole = single_query.Whole(mp, groups, i)
            hs = slice(i * H // mp, (i + 1) * H // mp)
            if groups > 1:
                gs = slice(i * kv_r // groups, (i + 1) * kv_r // groups)
        kr = krp[:, :, gs].contiguous()
        return (t1_ops.paged_decomposed_decode_fwd(r[:, hs].contiguous(), qr[:, hs].contiguous(),
                                                   xp, kr, bt_t, len_t, scale, whole=whole),
                t1_ops.paged_decomposed_prefill_fwd(rc[:, hs].contiguous(),
                                                    qc[:, hs].contiguous(), xp, kr, bt_t[-1],
                                                    offset, valid, scale, whole=whole)[:valid])

    whole_dec, whole_pre = calls(None)
    shards = [calls(i) for i in range(mp)]
    torch.cuda.synchronize()
    dec = torch.cat([d for d, _ in shards], dim=1)
    pre = torch.cat([p for _, p in shards], dim=1)
    return int((dec != whole_dec).sum().item()), int((pre != whole_pre).sum().item())


def mesh_want(mode: str, L: int, mp: int, stats: dict) -> dict:
    """The launches a serve over ``mp`` shards must make: each tier's kernel
    once a shard a layer a decode tick or a prompt chunk."""
    dec, chunks = L * mp * stats["decode_steps"], L * mp * stats["prefill_chunks"]
    if mode == "tiered":
        return {"paged_decode": dec, "paged_cpq_decode": dec, "chunks": chunks}
    d, c = MESH_KERNELS[mode]
    return {d: dec, c: chunks}


def check_mesh_launches(what: str, mode: str, counts: dict, want: dict) -> None:
    if mode == "tiered":
        chunks = counts.get("paged_prefill", 0) + counts.get("paged_cpq_prefill", 0)
        check(counts.get("paged_decode") == want["paged_decode"]
              and counts.get("paged_cpq_decode") == want["paged_cpq_decode"]
              and chunks == want["chunks"], f"{what}: launches {counts}, want {want}")
        return
    check({k: counts.get(k, 0) for k in want} == want
          and not any(n for k, n in counts.items() if k not in want),
          f"{what}: launches {counts}, want {want}")


def mesh_interconnect(cfg, mode: str, mp: int, stats: dict, slots: int, pool_x: int) -> float:
    """The reference's interconnect bytes of a chunked serve: (mp - 1) / mp
    of the concatenated head outputs for every token a model invocation
    writes (each prompt token of a chunk, each decode row), plus, for T1,
    the X pool gathered once an invocation (``pool_x`` bytes a layer)."""
    concat = (mp - 1) / mp * cfg.num_heads * cfg.head_dim * cfg.param_dtype.itemsize \
        * cfg.num_layers
    rows = stats["prefill_tokens"] + round(stats["slot_utilization"] * stats["decode_steps"]
                                           * slots)
    gather = (mp - 1) / mp * pool_x * cfg.num_layers if mode == "decomposed" else 0.0
    return rows * concat + (stats["decode_steps"] + stats["prefill_chunks"]) * gather


def streams_match(T, M, what: str, got: dict, want: dict, make_eng, reqs_fn,
                  gap: float = ARGMAX_GAP) -> int:
    """Greedy streams over the mesh against the unsharded engine's: equal,
    or a first divergence where the unsharded engine's own top-2 logit gap
    is below ``gap`` (the unsharded serve is then run again to read its
    gaps). Returns the number of identical streams."""
    if all(np.array_equal(got[r], want[r]) for r in want):
        log(f"{what}: greedy streams identical to the unsharded engine's for "
            f"{len(want)}/{len(want)} requests")
        return len(want)
    gaps, eng = {}, make_eng()
    eng.reset(T.GenerationConfig())
    for r in reqs_fn():
        eng.add_request(r)
    step = gather_gaps(M, eng, gaps)
    while eng.has_unfinished():
        step()
    del eng
    return compare_streams(what, {True: got, False: want}, gaps,
                           {r: len(want[r]) for r in want}, names=("mesh", "unsharded"),
                           gap=gap)


def mesh_serve(T, M, kmods: dict, routed: dict, cfg, params, mode: str, mp: int, sv, rt,
               base: dict, smi: str) -> dict:
    """One serve of ``make_requests`` over make_serve_mesh(1, mp) against the
    unsharded serve ``base`` ({"streams", "metrics", "make"}: its streams,
    serve_metrics and an engine factory): launches and routes, streams,
    mesh statistics, tick times."""
    from repro_torch.launch.mesh import make_serve_mesh

    what = f"(v2) {mode} mp {mp} at {cfg.num_layers} layers"
    mesh = make_serve_mesh(1, mp, devices=mesh_devices(mp))
    eng = T.ContinuousServeEngine(cfg, params, rt=rt, serving=sv, mesh=mesh)
    for name, mod in kmods.items():
        getattr(mod, name).launches = 0
    zero_routes(routed)
    reqs_fn = lambda: make_requests(T, cfg.vocab_size)  # noqa: E731
    results, stats, ticks, wall = serve_timed(eng, T, reqs_fn())
    counts = {name: getattr(mod, name).launches for name, mod in kmods.items()
              if getattr(mod, name).launches}
    del eng
    torch.cuda.empty_cache()
    check_finished(results, reqs_fn(), what)
    check_mesh_launches(what, mode, counts, mesh_want(mode, cfg.num_layers, mp, stats))
    routes = check_routes(what, routed, counts)
    met = serve_metrics(stats, ticks, wall, what)
    got = {rid: r["tokens"] for rid, r in results.items()}
    identical = streams_match(T, M, what, got, base["streams"], base["make"], reqs_fn)
    pool_x = sv.num_pages * sv.page_size * cfg.d_model * cfg.param_dtype.itemsize
    want_ic = mesh_interconnect(cfg, mode, mp, stats, sv.num_slots, pool_x)
    check(stats["model_shards"] == mp, f"{what}: model_shards {stats['model_shards']}")
    check(stats["arena_bytes_per_device"] * mp == stats["arena_bytes_total"],
          f"{what}: arena {stats['arena_bytes_per_device']} a device of "
          f"{stats['arena_bytes_total']}")
    check(abs(stats["interconnect_bytes"] - want_ic) <= 1e-9 * want_ic,
          f"{what}: interconnect {stats['interconnect_bytes']} vs {want_ic}")
    if mode == "tiered":
        check(stats["escalations"] >= 1, f"{what}: no escalation")
    b = base["metrics"]
    log(f"{what}: decode tick median {met['decode_step_ms_median']:.3f} ms (p90 "
        f"{met['decode_step_ms_p90']:.3f}) vs unsharded {b['decode_step_ms_median']:.3f} (p90 "
        f"{b['decode_step_ms_p90']:.3f}); decode {met['decode_tokens_per_s']:.1f} vs "
        f"{b['decode_tokens_per_s']:.1f} tokens/s ({smi}); arena "
        f"{stats['arena_bytes_per_device'] / 2**20:.1f} MiB a device of "
        f"{stats['arena_bytes_total'] / 2**20:.1f}; interconnect "
        f"{stats['interconnect_bytes_per_token']:.1f} B/token; launches {counts}")
    return {**met, "layers": cfg.num_layers, "launches": counts, "routes": routes,
            "streams_identical": identical, "model_shards": mp,
            "arena_bytes_per_device": stats["arena_bytes_per_device"],
            "arena_bytes_total": stats["arena_bytes_total"],
            "interconnect_bytes_per_token": stats["interconnect_bytes_per_token"],
            "escalations": stats.get("escalations", 0),
            "unsharded_decode_step_ms_median": b["decode_step_ms_median"],
            "unsharded_decode_step_ms_p90": b["decode_step_ms_p90"],
            "unsharded_decode_tokens_per_s": b["decode_tokens_per_s"],
            "devices": [str(d) for d in mesh.axis_devices("model")]}


def mesh_serves(T, M, kmods: dict, routed: dict, unsharded: dict, smi: str, t3_cfg,
                depth: int) -> dict:
    """(v2): full-width qwen1.5-0.5b in bf16 over model shards, phase 4's
    requests and arenas: MESH_FULL's serves (dense and T1 over
    make_serve_mesh(1, 2)) at all 24 layers against phase 4's unsharded
    serves (their streams and tick times); cpq, retrieval and tiered over
    (1, 2) and dense over (1, 4) at the first ``depth`` layers, each against
    an unsharded serve of the same layers made here (phase 4's at 24). On
    two cards or more, each card's memory_allocated under the dense serve
    over two of them."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.params import init_params

    full = served_config(T)
    params = init_params(full, SEED, DEVICE)
    serving = T.ServingCfg(num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64)
    tiered = T.ServingCfg(num_slots=8, page_size=16, num_pages=97, max_blocks_per_slot=64,
                          escalated_pages=513, low_watermark=0.5, critical_watermark=0.45,
                          enable_escalation=True)
    rts = {mode: T.AttentionRuntime(mode=mode) for mode in ("dense", "cpq", "decomposed")}
    rts["retrieval"] = T.AttentionRuntime(mode="retrieval", retrieval=t3_cfg)
    rts["tiered"] = T.AttentionRuntime(mode="dense")
    shared = torch.cuda.device_count() < 2
    log(f"(v2) {'the shards share one card' if shared else 'one card a shard'} ({smi}): "
        f"{torch.cuda.device_count()} visible")
    cut = dataclasses.replace(full, num_blocks=depth)
    cut_params = {**params, "blocks": [b[:depth] for b in params["blocks"]]}

    def unsharded_of(cfg, p, mode, sv):
        make = lambda: T.ContinuousServeEngine(cfg, p, rt=rts[mode], serving=sv,  # noqa: E731
                                               device=DEVICE)
        if cfg.num_layers == full.num_layers:  # phase 4 served it
            return {"streams": unsharded[mode], "metrics": unsharded[f"{mode} metrics"],
                    "make": make}
        res, stats, ticks, wall = serve_timed(make(), T, make_requests(T, cfg.vocab_size))
        torch.cuda.empty_cache()
        return {"streams": {rid: r["tokens"] for rid, r in res.items()}, "make": make,
                "metrics": serve_metrics(stats, ticks, wall, f"(v2) {mode} unsharded at "
                                         f"{cfg.num_layers} layers")}

    out = {}
    for mode, mp in [(m, 2) for m in MESH_MODES] + [("dense", 4)]:
        cfg, p = (full, params) if (mode, mp) in MESH_FULL else (cut, cut_params)
        sv = tiered if mode == "tiered" else serving
        out[f"{mode} mp{mp}"] = mesh_serve(T, M, kmods, routed, cfg, p, mode, mp, sv,
                                           rts[mode], unsharded_of(cfg, p, mode, sv), smi)
    if not shared:  # distinct cards: what each one holds
        mesh = make_serve_mesh(1, 2, devices=mesh_devices(2))
        eng = T.ContinuousServeEngine(full, params, rt=rts["dense"], serving=serving, mesh=mesh)
        serve_timed(eng, T, make_requests(T, full.vocab_size))
        out["memory_allocated"] = {str(d): torch.cuda.memory_allocated(d)
                                   for d in mesh.axis_devices("model")}
        log(f"(v2) dense over 2 cards: memory_allocated {out['memory_allocated']}")
        del eng
    del params, cut_params
    torch.cuda.empty_cache()
    return out


def mesh_parity(T, M, t3_cfg, report: dict) -> dict:
    """(v3): float32 at PARITY_DEPTH layers, over make_serve_mesh(1, 2)
    against unsharded on the card, dense and decomposed (MESH_PARITY_MODES:
    the other modes' bf16 serves of (v2) are already bit-identical to
    unsharded, PERF.md): the first logits of two
    slots within MESH_LOGIT_TOL and the greedy streams identical (a first
    divergence excused only below ARGMAX_GAP); then the card's sharded
    engine against the CPU's (shards that share the CPU), dense: first
    logits within MESH_CPU_TOL and two requests' streams identical (a CPU
    near tie below ARGMAX_GAP excused)."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.params import init_params, to_device

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(served_config(T), dtype="float32", num_blocks=PARITY_DEPTH)
    params = init_params(cfg, SEED, DEVICE)
    mesh = make_serve_mesh(1, 2, devices=mesh_devices(2))
    reqs = make_requests(T, cfg.vocab_size)
    small = T.ServingCfg(num_slots=2, page_size=16, num_pages=80, max_blocks_per_slot=64)
    bt = np.zeros((2, 64), np.int32)
    lens = [len(reqs[0].prompt), len(reqs[1].prompt)]
    perm = np.random.default_rng(SEED).permutation(np.arange(1, 80))
    bt[0, :lens[0] // 16 + 1] = perm[:lens[0] // 16 + 1]
    bt[1, :lens[1] // 16 + 1] = perm[40:40 + lens[1] // 16 + 1]
    serving = T.ServingCfg(num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64)
    tiered = T.ServingCfg(num_slots=8, page_size=16, num_pages=97, max_blocks_per_slot=64,
                          escalated_pages=513, low_watermark=0.5, critical_watermark=0.45,
                          enable_escalation=True)
    out = {}
    for mode in MESH_PARITY_MODES:
        what = f"(v3) {mode}"
        rt = T.AttentionRuntime(mode="dense" if mode == "tiered" else mode,
                                **({"retrieval": t3_cfg} if mode == "retrieval" else {}))
        sv = tiered if mode == "tiered" else serving
        rec = {}
        if mode != "tiered":  # the tiered arena's first logits are dense's
            a = first_logits(M, cfg, rt, params, reqs, small, bt)
            b = first_logits(M, cfg, dataclasses.replace(rt, mesh=mesh), params, reqs, small, bt)
            rec = {f"{n}_logits_max_abs_diff": (x - y).abs().max().item()
                   for n, x, y in zip(("prefill", "first-decode"), a, b)}
            for n, err in rec.items():
                log(f"{what}: {n} {err:.3e}, sharded vs unsharded (tol {MESH_LOGIT_TOL})")
                check(err <= MESH_LOGIT_TOL, f"{what}: {n} {err:.3e}")
        runs = {}
        for sharded in (True, False):
            eng = T.ContinuousServeEngine(cfg, params, rt=rt, serving=sv,
                                          **({"mesh": mesh} if sharded else {"device": DEVICE}))
            res, _ = eng.serve(make_requests(T, cfg.vocab_size))
            runs[sharded] = {rid: r["tokens"] for rid, r in res.items()}
            del eng
        rec["streams_identical"] = streams_match(
            T, M, what, runs[True], runs[False],
            lambda rt=rt, sv=sv: T.ContinuousServeEngine(cfg, params, rt=rt, serving=sv,
                                                         device=DEVICE),
            lambda: make_requests(T, cfg.vocab_size))
        out[mode] = rec
    # the card's sharded engine against the CPU's, dense
    cpu_params = to_device(params, "cpu")
    cpu_mesh = make_serve_mesh(1, 2, devices="cpu")
    rt = T.AttentionRuntime(mode="dense")
    card = first_logits(M, cfg, dataclasses.replace(rt, mesh=mesh), params, reqs, small, bt)
    cpu = first_logits(M, cfg, dataclasses.replace(rt, mesh=cpu_mesh), cpu_params, reqs,
                       small, bt, device="cpu")
    rec = {f"{n}_logits_max_abs_diff": (x.cpu() - y).abs().max().item()
           for n, x, y in zip(("prefill", "first-decode"), card, cpu)}
    for n, err in rec.items():
        log(f"(v3) card vs CPU, sharded: {n} {err:.3e} (tol {MESH_CPU_TOL})")
        check(err <= MESH_CPU_TOL, f"(v3) card vs CPU: {n} {err:.3e}")
    two = [T.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=MESH_CPU_NEW) for r in reqs[:2]]
    small_sv = T.ServingCfg(num_slots=2, page_size=16, num_pages=80, max_blocks_per_slot=64)
    cres, _ = T.ContinuousServeEngine(cfg, params, rt=rt, serving=small_sv,
                                      mesh=mesh).serve(list(two))
    gaps, eng = {}, T.ContinuousServeEngine(cfg, cpu_params, rt=rt, serving=small_sv,
                                            mesh=cpu_mesh)
    eng.reset(T.GenerationConfig())
    for r in two:
        eng.add_request(T.Request(rid=r.rid, prompt=r.prompt, max_new_tokens=MESH_CPU_NEW))
    step = gather_gaps(M, eng, gaps)
    while eng.has_unfinished():
        step()
    rec["streams_identical"] = compare_streams(
        "(v3) card vs CPU, sharded",
        {True: {rid: r["tokens"] for rid, r in cres.items()},
         False: {rid: r["tokens"] for rid, r in eng.results().items()}},
        gaps, {r.rid: MESH_CPU_NEW for r in two}, names=("card", "CPU"))
    out["card vs CPU"] = rec
    del params, cpu_params, eng
    torch.cuda.empty_cache()
    return out


def mesh_mla(T, M, kmods: dict, routed: dict) -> dict:
    """(v4): deepseek-v2-lite at its published widths cut to MOE_DEPTH layers
    (one-shot admission: its MoE layers) over make_serve_mesh(1, 2) against
    unsharded, in bf16 (B3 once a shard a layer a decode tick on its tensor
    cores over the latent gathered whole) and in float32 (B3's sweep): the
    greedy streams identical to the unsharded engine's (a first divergence
    excused below ARGMAX_GAP)."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.params import init_params

    out = {}
    mesh = make_serve_mesh(1, 2, devices=mesh_devices(2))
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(deepseek_config(T, "deepseek-v2-lite-16b",
                                                  MOE_DEPTH - len(T.ARCHS[
                                                      "deepseek-v2-lite-16b"].prefix_pattern)),
                                  dtype=dtype)
        params = init_params(cfg, SEED, DEVICE)
        serving = T.ServingCfg(**DEEPSEEK_SERVING)
        what = f"(v4) deepseek-v2-lite {dtype} at {cfg.num_layers} layers"
        runs = {}
        for sharded in (True, False):
            for name, mod in kmods.items():
                getattr(mod, name).launches = 0
            zero_routes(routed)
            eng = T.ContinuousServeEngine(cfg, params, serving=serving,
                                          **({"mesh": mesh} if sharded else {"device": DEVICE}))
            res, stats = eng.serve(make_requests(T, cfg.vocab_size))
            counts = {name: getattr(mod, name).launches for name, mod in kmods.items()
                      if getattr(mod, name).launches}
            runs[sharded] = ({rid: r["tokens"] for rid, r in res.items()}, stats, counts)
            del eng
            if sharded and dtype == "bfloat16":
                check_routes(what, routed, counts)
        got, stats, counts = runs[True]
        want = {"paged_decomposed_decode": cfg.num_layers * 2 * stats["decode_steps"]}
        paged = {k: n for k, n in counts.items() if k.startswith("paged")}
        check(paged == want, f"{what}: launches {counts}, want {want} (and B8's prompts)")
        rec = {"launches": counts, "interconnect_bytes_per_token":
               stats["interconnect_bytes_per_token"],
               "arena_bytes_per_device": stats["arena_bytes_per_device"],
               "arena_bytes_total": stats["arena_bytes_total"]}
        rec["streams_identical"] = streams_match(
            T, M, what, got, runs[False][0],
            lambda: T.ContinuousServeEngine(cfg, params, serving=serving, device=DEVICE),
            lambda: make_requests(T, cfg.vocab_size))
        log(f"{what}: B3 launches {counts} ({cfg.num_layers} layers x 2 shards a decode "
            f"tick); streams identical to unsharded {rec['streams_identical']}/{len(got)}; arena "
            f"{stats['arena_bytes_per_device'] / 2**20:.1f} MiB a device of "
            f"{stats['arena_bytes_total'] / 2**20:.1f}; interconnect "
            f"{stats['interconnect_bytes_per_token']:.1f} B/token")
        out[dtype] = rec
        del params
        torch.cuda.empty_cache()
    return out


def mesh_collectives() -> dict:
    """(v5): flash decoding, the ring scores and GPipe over CUDA shards (8, 8
    and 4 of them: the cards, or one card repeated) against the computation
    on one device, at tests/test_distributed.py's sizes; flash decoding
    also at qwen1.5-0.5b's decode shape (8 rows, 16 heads of 64, a capacity
    of 1024 keys over 2 shards, bf16)."""
    from repro_torch.distributed.collectives import (flash_decoding_attention,
                                                     ring_decomposed_scores, shard_along)
    from repro_torch.distributed.pipeline import gpipe_forward
    from repro_torch.distributed.sharding import Mesh

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=DEVICE)

    def line(n, name):
        return Mesh(np.array(mesh_devices(n), dtype=object), (name,))

    def dense(q, k, v, length, scale):
        g = q.shape[2] // k.shape[2]
        kk, vv = k.repeat_interleave(g, 2).float(), v.repeat_interleave(g, 2).float()
        s = torch.einsum("bhd,bnhd->bhn", q[:, 0].float(), kk) * scale
        s[..., length:] = -1e30
        return torch.einsum("bhn,bnhd->bhd", torch.softmax(s, -1), vv)[:, None]

    out = {}
    for what, (B, H, KV, Dh, N, n, length, dtype, tol) in {
            "flash decoding (test sizes)": (2, 8, 4, 32, 128, 8, 100, torch.float32, 1e-5),
            "flash decoding (qwen decode)": (8, 16, 16, 64, 1024, 2, 1000, torch.bfloat16,
                                             2e-2)}.items():
        mesh = line(n, "s")
        q, k, v = (randn(B, 1, H, Dh).to(dtype), randn(B, N, KV, Dh).to(dtype),
                   randn(B, N, KV, Dh).to(dtype))
        devs = mesh.axis_devices("s")
        got = flash_decoding_attention(mesh, "s")(q, shard_along(k, 1, devs),
                                                  shard_along(v, 1, devs), length, Dh ** -0.5)
        out[what] = (got.float() - dense(q, k, v, length, Dh ** -0.5)).abs().max().item()
    r, x = randn(2, 16, 64), randn(2, 128, 64)
    mesh = line(8, "s")
    devs = mesh.axis_devices("s")
    parts = ring_decomposed_scores(mesh, "s")(shard_along(r, 1, devs), shard_along(x, 1, devs))
    out["ring scores"] = (torch.cat([p.to(DEVICE) for p in parts], 1)
                          - torch.einsum("bhm,bnm->bhn", r, x)).abs().max().item()
    w, xm = randn(8, 16, 16) / 4.0, randn(6, 2, 16)
    got = gpipe_forward(line(4, "pod"), "pod", lambda p, h: torch.tanh(h @ p))(w, xm)
    seq = xm
    for i in range(8):
        seq = torch.tanh(seq @ w[i])
    out["gpipe"] = (got - seq).abs().max().item()
    tols = {"flash decoding (test sizes)": 1e-5, "flash decoding (qwen decode)": 2e-2,
            "ring scores": 2e-4, "gpipe": 1e-6}
    for what, err in out.items():
        log(f"(v5) {what}: {err:.3e} against one device (tol {tols[what]})")
        check(err <= tols[what], f"(v5) {what}: {err:.3e}")
    return out


def mesh_launcher(T) -> dict:
    """(v6): the serve entry point with --mesh 1,2 at full width where two
    cards are visible; on one card its refusal, naming the count."""
    from repro_torch.launch import serve

    argv = ["--arch", "qwen1.5-0.5b", "--continuous", "--mesh", "1,2", *LAUNCH_SHAPE]
    if torch.cuda.device_count() < 2:
        try:
            serve.main(argv)
        except ValueError as e:
            check(str(e).startswith("mesh (1,2) needs 2 devices, have 1 "),
                  f"(v6) the launcher's refusal: {e}")
            log(f"(v6) one card: --mesh 1,2 refused: {e}")
            return {"refused": str(e)}
        check(False, "(v6) --mesh 1,2 served on one card")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = serve.main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"(v6) {line}")
    check(got.shape == (8, 32) and any(ln.startswith("[serve] mesh: data=1 model=2")
                                       for ln in lines), "(v6) --mesh 1,2: output or mesh line")
    return {"lines": lines}


def mesh_phase(T, M, ops, cpq_ops, t1_ops, t3_ops, kmods: dict, routed: dict, errs: dict,
               unsharded: dict, smi: str, t3_cfg, report: dict, depth: int) -> None:
    """Phase 11: the serving mesh, (v1)-(v6); (v2)'s cut serves at
    ``depth`` layers."""
    t0 = time.perf_counter()
    seconds, rep = {}, {}
    for what, fn in (
            ("(v1)", lambda: shard_kernel_sweeps(ops, cpq_ops, t1_ops, t3_ops, errs)),
            ("(v2)", lambda: rep.update(serves=mesh_serves(T, M, kmods, routed, unsharded,
                                                           smi, t3_cfg, depth))),
            ("(v3)", lambda: rep.update(parity=mesh_parity(T, M, t3_cfg, report))),
            ("(v4)", lambda: rep.update(mla=mesh_mla(T, M, kmods, routed))),
            ("(v5)", lambda: rep.update(collectives=mesh_collectives())),
            ("(v6)", lambda: rep.update(launcher=mesh_launcher(T)))):
        t1 = time.perf_counter()
        fn()
        seconds[what] = time.perf_counter() - t1
    rep["seconds"], rep["step_seconds"] = time.perf_counter() - t0, seconds
    report["mesh"] = rep
    log(f"[{time.perf_counter() - T0:.0f} s] phase 11 (mesh) took {rep['seconds']:.1f} s: "
        + ", ".join(f"{k} {s:.1f}" for k, s in seconds.items()))


# ------------------------------------------------------------------ main


def check_finished(results, reqs, what: str) -> None:
    for r in reqs:
        got = results[r.rid]
        check(got["finish_reason"] == "max_tokens" and len(got["tokens"]) == r.max_new_tokens,
              f"{what}: request {r.rid}: {got['finish_reason']}, {len(got['tokens'])} tokens")


def serve_metrics(stats, ticks, wall, what: str) -> dict:
    """Tick times of the decode-only ticks, decode and end-to-end rates."""
    pure = [(ms, rows) for ms, rows, chunk, dec in ticks if dec and not chunk]
    step_ms = float(np.median([ms for ms, _ in pure]))
    rows_per = float(np.mean([rows for _, rows in pure]))
    out = {"ticks": len(ticks), "decode_steps": stats["decode_steps"],
           "prefill_chunks": stats["prefill_chunks"], "pure_decode_ticks": len(pure),
           "decode_step_ms_median": step_ms,
           "decode_step_ms_p90": float(np.percentile([ms for ms, _ in pure], 90)),
           "rows_per_decode_step": rows_per,
           "decode_tokens_per_s": rows_per / step_ms * 1e3,
           "generated_tokens": stats["generated_tokens"], "serve_wall_s": wall,
           "end_to_end_tokens_per_s": stats["generated_tokens"] / wall,
           "arena_bytes": stats["arena_bytes_total"],
           "bytes_per_token_layer": stats["bytes_per_token_layer"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    log(f"serve {what}: {out['ticks']} ticks ({out['decode_steps']} decode, "
        f"{out['prefill_chunks']} prefill chunks); decode step median {step_ms:.3f} ms "
        f"(p90 {out['decode_step_ms_p90']:.3f}) over {len(pure)} decode-only ticks at "
        f"{rows_per:.2f} rows = {out['decode_tokens_per_s']:.1f} tokens/s; end to end "
        f"{out['end_to_end_tokens_per_s']:.1f} tokens/s over {wall:.2f} s; arena "
        f"{out['arena_bytes'] / 1e9:.3f} GB")
    return out


def serve_recorded(eng, T, reqs, recorders: dict):
    """Serve with each kernel wrapper ``module.name`` replaced by its
    Recorder, the launch counts set to 0 just before and read just after.
    recorders: {name: (module, Recorder)}."""
    for name, (mod, rec) in recorders.items():
        setattr(mod, name, rec)
        rec.fn.launches = 0
    try:
        results, stats, ticks, wall = serve_timed(eng, T, reqs)
    finally:
        for name, (mod, rec) in recorders.items():
            setattr(mod, name, rec.fn)
    return results, stats, ticks, wall, {n: rec.fn.launches for n, (_, rec) in recorders.items()}


def log_timing(name, t, launches, per_tick, unit="tick") -> None:
    log(f"{name}: {t['ms'] * 1e3:.2f} us/launch on the device, {t['eager_ms'] * 1e3:.2f} "
        f"us launched eagerly (bound {t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}; "
        f"plain {t['plain_ms'] * 1e3:.1f} us, library {t['library_ms'] * 1e3:.1f} us) over "
        f"{t['samples']} sampled calls; {launches} launches, {per_tick:.0f} per {unit}")


# ------------------------------- phase 4: the rest of the continuous tick

TURNS = 3                   # make_templated_workload's turns per session (h)
COUNTERS = ("prefix_hits", "shared_prefix_tokens", "shared_prefix_pages", "cow_copies",
            "defrags", "spec_steps", "spec_drafted", "spec_accepted", "preemptions",
            "timeouts")
SAMPLE_GAP = 1e-6           # relative top-2 gap of perturbed logits below which a draw is a tie


def templated_requests(T, work):
    """(h)'s requests: the turns of sessions 0, 2, 4 and 6 sampled
    (temperature 0.8, top-k 50, top-p 0.9, seed 100 + rid), the others
    greedy. make_templated_workload numbers a session's turns in a row, so
    a request's session is rid // TURNS."""
    out = []
    for w in work:
        sess = w.rid // TURNS
        sp = (T.SamplingParams(temperature=0.8, top_k=50, top_p=0.9, seed=100 + w.rid,
                               max_tokens=w.target) if sess % 2 == 0
              else T.SamplingParams(max_tokens=w.target))
        out.append(T.ServeRequest(prompt=w.prompt, rid=w.rid, sampling=sp, arrival=w.arrival,
                                  session_id=f"s{sess}"))
    return out


def loopy_requests(T, work):
    """(i)'s greedy requests."""
    return [T.Request(rid=w.rid, prompt=w.prompt, max_new_tokens=w.target, arrival=w.arrival)
            for w in work]


def cow_probe(T, eng, sys_prompt, vocab: int):
    """Two greedy requests behind (h)'s system prompt of 256 tokens: A, and
    B, which diverges from it 250 tokens in (10 tokens into its 16th page)
    and is added once A's 20 prompt chunks have landed. B mounts 15 pages
    and shares the 16th mid-page, and its first tail write splits that page
    (copy-on-write). (h)'s own prompts diverge at page boundaries only.
    Returns (results, stats)."""
    rng = np.random.default_rng(SEED + 1)
    a = np.concatenate([sys_prompt, rng.integers(1, vocab, 64)]).astype(np.int32)
    b = np.concatenate([sys_prompt[:250], rng.integers(1, vocab, 40)]).astype(np.int32)
    eng.reset(T.GenerationConfig())
    eng.add_request(T.Request(rid=0, prompt=a, max_new_tokens=16))
    for _ in range(22):
        eng.step()
    eng.add_request(T.Request(rid=1, prompt=b, max_new_tokens=16))
    while eng.has_unfinished():
        eng.step()
    return eng.results(), eng.stats()


def check_targets(results, targets: dict, what: str) -> None:
    for rid, n in targets.items():
        got = results[rid]
        check(got["finish_reason"] == "max_tokens" and len(got["tokens"]) == n,
              f"{what}: request {rid}: {got['finish_reason']}, {len(got['tokens'])} of {n}")


def check_tick_launches(what: str, counts: dict, stats: dict, L: int) -> None:
    """B1 and B2 alone launched, L times a decode step and a chunk or
    verify chunk; a verify chunk counts as a decode step in ``stats``."""
    spec = stats["spec_steps"]
    want = {name: 0 for name in counts}
    want.update(paged_decode=L * (stats["decode_steps"] - spec),
                paged_prefill=L * (stats["prefill_chunks"] + spec))
    check(counts == want and want["paged_decode"] > 0 and want["paged_prefill"] > 0,
          f"{what}: launch counts {counts}, want {want}")
    check(stats["dense_pages_leaked"] == 0, f"{what}: {stats['dense_pages_leaked']} pages leaked")


def log_counters(what: str, stats: dict) -> dict:
    out = {k: stats[k] for k in COUNTERS}
    log(f"serve {what}: " + ", ".join(f"{k} {v}" for k, v in out.items()))
    return out


def watch_gaps(eng, gaps: dict) -> None:
    """File the top-2 logit gap of every greedy draw of ``eng`` under (rid,
    stream index): first tokens, the decode step's rows and every position
    of a verify chunk. A row's later draw of the same index overwrites an
    earlier filing (a row that was not active in that decode step)."""
    one, active, verify = eng._sample_one, eng._sample_active, eng._verify_draws

    def greedy(req):
        return req.sampling is None or req.sampling.temperature <= 0

    def sample_one(req, logits):
        if greedy(req):
            gaps[(req.rid, req.num_generated)] = top2_gap(logits[0]).item()
        return one(req, logits)

    def sample_active(st, logits):
        g = top2_gap(logits).tolist()
        for slot, req in enumerate(st.sched.slots):
            if req is not None and greedy(req):
                gaps[(req.rid, req.num_generated)] = g[slot]
        return active(st, logits)

    def verify_draws(req, logits):
        if greedy(req):
            for j, x in enumerate(top2_gap(logits).tolist()):
                gaps[(req.rid, req.num_generated + j)] = x
        return verify(req, logits)

    eng._sample_one, eng._sample_active, eng._verify_draws = sample_one, sample_active, verify_draws


def tick_parity(T, cfg, params, what: str, serving, off: dict, drive) -> dict:
    """Float32, TF32 off: ``drive(eng) -> (results, stats)`` on the kernel
    path and on the plain path with ``serving``, and on the kernel path with
    the feature off (``serving`` updated by ``off``). The paths' streams
    (greedy and sampled) identical but for a greedy first divergence below
    ARGMAX_GAP of the plain path's top-2 gap, and then their counters too;
    the feature on and off give identical streams the same way."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runs = {}
    for key, fused, sv in (("kernels", True, serving), ("plain", False, serving),
                           ("off", True, dataclasses.replace(serving, **off))):
        eng = T.ContinuousServeEngine(cfg, params, rt=T.AttentionRuntime(paged_kernels=fused),
                                      serving=sv, device=DEVICE)
        gaps = {}
        watch_gaps(eng, gaps)
        results, stats = drive(eng)
        runs[key] = ({rid: r["tokens"] for rid, r in results.items()}, stats, gaps)
        del eng
        torch.cuda.empty_cache()
    lengths = {rid: len(t) for rid, t in runs["plain"][0].items()}
    out = {"counters": {k: runs["kernels"][1][k] for k in COUNTERS}}
    same = compare_streams(what, {True: runs["kernels"][0], False: runs["plain"][0]},
                           runs["plain"][2], lengths)
    out["streams_identical"] = same
    keys = COUNTERS + ("decode_steps", "prefill_chunks", "generated_tokens")
    if same == len(lengths):
        differ = {k: (runs["kernels"][1][k], runs["plain"][1][k]) for k in keys
                  if runs["kernels"][1][k] != runs["plain"][1][k]}
        check(not differ, f"parity {what}: counters differ, kernels vs plain: {differ}")
        log(f"parity {what}: counters identical, kernels vs plain: {out['counters']}")
    out["on_off_identical"] = compare_streams(
        f"{what} on vs off", {True: runs["kernels"][0], False: runs["off"][0]},
        runs["off"][2], lengths)
    return out


def sampler_parity(teng, prng) -> dict:
    """The sampler on the card against itself on the CPU, on the same
    float32 logits (32 rows of 151936), temperatures, top-k, top-p, seeds
    and stream indices: the Threefry bits and uniforms bit for bit, and the
    same draws but where the CPU's top-2 perturbed logits lie within
    SAMPLE_GAP (relative) and the two draws are those two (excused,
    counted). Gumbel noise: its largest difference in ulps at the scale of
    max(|g|, 1) (no gate). Also the card's time of one 8-row call."""
    rng = np.random.default_rng(SEED)
    B, V = 32, 151936
    host = [torch.tensor(a) for a in (
        (rng.normal(size=(B, V)) * 3).astype(np.float32),
        rng.choice([0.0, 0.5, 0.8, 1.0, 1.3], size=B).astype(np.float32),
        rng.choice([0, 50, 1000], size=B).astype(np.int32),
        rng.choice([1.0, 0.9, 0.6], size=B).astype(np.float32),
        rng.integers(0, 2**31 - 1, size=B).astype(np.int32),
        rng.integers(0, 4096, size=B).astype(np.int32))]
    card = [t.to(DEVICE) for t in host]
    keys = [prng.fold_in(prng.PRNGKey(a[4]), a[5]) for a in (host, card)]
    check(torch.equal(prng.random_bits(keys[1], (V,)).cpu(), prng.random_bits(keys[0], (V,))),
          "sampler: the card's Threefry bits differ from the CPU's")
    check(torch.equal(prng.uniform(keys[1], (V,)).cpu(), prng.uniform(keys[0], (V,))),
          "sampler: the card's uniforms differ from the CPU's")
    g = [prng.gumbel(k, (V,)).double().cpu() for k in keys]
    ulps = ((g[1] - g[0]).abs() / torch.from_numpy(np.spacing(
        np.maximum(g[0].abs().numpy(), 1.0).astype(np.float32))).double()).max().item()
    got = [teng.sample_token_rows(*a).cpu() for a in (host, card)]
    pert = teng.perturbed_logits(*host)
    diff = torch.nonzero(got[1] != got[0])[:, 0].tolist()
    for b in diff:
        top2 = pert[b].topk(2)
        a0, a1 = top2.values.tolist()
        tie = abs(a0 - a1) <= SAMPLE_GAP * max(abs(a0), abs(a1), 1.0)
        check(host[1][b] > 0 and tie and {int(got[0][b]), int(got[1][b])}
              == set(top2.indices.tolist()),
              f"sampler: row {b} draws {int(got[1][b])} on the card, {int(got[0][b])} on "
              f"the CPU, top-2 perturbed {a0!r} {a1!r}")
    ms = cuda_ms(lambda: teng.sample_token_rows(*[t[:8] for t in card]), 20)
    out = {"draws": B, "excused": len(diff), "gumbel_max_ulps": ulps,
           "sample_token_rows_8_rows_ms": ms}
    log(f"sampler, card vs CPU: bits and uniforms identical; {B} draws, {len(diff)} excused "
        f"(top-2 perturbed within {SAMPLE_GAP} relative); gumbel within {ulps:.1f} ulp of "
        f"max(|g|, 1) (no gate); sample_token_rows over 8 rows of {V}: {ms:.3f} ms on the card")
    return out


def serve_rest(T, cfg, params, serving, counted: list, routed: dict, fa_routes: dict,
               serves: dict, new_s: dict) -> dict:
    """Phase 4's serves of the rest of the continuous engine's tick, on
    serve (a)'s arena (``serving``), each with every launch and route count
    set to 0 just before and read just after; B1 and B2 alone launch, once
    a layer a decode step and a prompt or verify chunk, every chunk on B2's
    tensor cores, every decode on B1's ring. Fills ``serves`` and the
    seconds ``new_s``; returns the traffic phase 5 replays."""
    # 4h) prefix sharing with copy-on-write and defrag: multi-turn sessions
    #     behind one system prompt, sessions 0, 2, 4, 6 sampled, the others
    #     greedy; then the copy-on-write probe behind the same prompt
    # 4i) speculative decoding on self-similar prompts, greedy
    # 4j) mixed interactive and batch traffic through run_trace, under the
    #     slo policy and under fifo
    from repro_torch.serving import trace

    L = cfg.num_layers
    t0 = time.perf_counter()
    work_h = trace.make_templated_workload(seed=0, n_sessions=8, vocab=cfg.vocab_size,
                                           rate=0.5, sys_tokens=256, turns=TURNS,
                                           turn_step=64)
    work_i = trace.make_loopy_workload(seed=0, n_requests=8, vocab=cfg.vocab_size, motif=32,
                                       reps=4, target=64)
    shared = dataclasses.replace(serving, share_prefix=True, defrag_every=4)
    spec = dataclasses.replace(serving, spec_len=4, spec_ngram=3)
    sys_prompt = work_h[0].prompt[:256]
    for what, sv, run, targets in (
            ("shared", shared, templated_requests(T, work_h), {w.rid: w.target for w in work_h}),
            ("shared cow", dataclasses.replace(shared, defrag_every=0), None, {0: 16, 1: 16}),
            ("speculative", spec, loopy_requests(T, work_i), {w.rid: w.target for w in work_i})):
        eng = T.ContinuousServeEngine(cfg, params, serving=sv, device=DEVICE)
        zero_launches(counted, fa_routes)
        zero_routes(routed)
        t1 = time.perf_counter()
        if run is None:
            results, stats = cow_probe(T, eng, sys_prompt, cfg.vocab_size)
            torch.cuda.synchronize()
            wall, ticks = time.perf_counter() - t1, None
        else:
            results, stats, ticks, wall = serve_timed(eng, T, run)
        counts = counted_launches(counted, fa_routes)
        routes = check_routes(what, routed, counts)
        check_targets(results, targets, what)
        check_tick_launches(what, counts, stats, L)
        serves[what] = (serve_metrics(stats, ticks, wall, what) if ticks else
                        {"serve_wall_s": wall, "generated_tokens": stats["generated_tokens"],
                         "end_to_end_tokens_per_s": stats["generated_tokens"] / wall,
                         "arena_bytes": stats["arena_bytes_total"]})
        serves[what].update(launches={k: n for k, n in counts.items() if n}, routes=routes,
                            counters=log_counters(what, stats))
        new_s[what] = time.perf_counter() - t1
        del eng
        torch.cuda.empty_cache()
        log(f"[{time.perf_counter() - T0:.0f} s] served {what} in {new_s[what]:.1f} s")
    h, c, i = serves["shared"]["counters"], serves["shared cow"]["counters"], \
        serves["speculative"]["counters"]
    check(h["prefix_hits"] > 0 and h["defrags"] > 0, f"shared: counters {h}")
    check(c["cow_copies"] >= 1 and c["shared_prefix_tokens"] == 250,
          f"shared cow: counters {c}")
    check(i["spec_steps"] > 0 and i["spec_accepted"] > 0, f"speculative: counters {i}")
    work_j, slos_j = trace.make_slo_workload(seed=0, n_requests=24, vocab=cfg.vocab_size,
                                             rate=0.5)
    kept = []

    class Kept(T.ContinuousServeEngine):  # run_trace's engine, for its leak count
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    made = trace.ContinuousServeEngine
    for pol in ("slo", "fifo"):
        what = f"slo workload, policy {pol}"
        zero_launches(counted, fa_routes)
        zero_routes(routed)
        t1 = time.perf_counter()
        trace.ContinuousServeEngine = Kept
        try:
            m = trace.run_trace(cfg, params, work_j, serving, policy=pol, slos=slos_j)
        finally:
            trace.ContinuousServeEngine = made
        counts = counted_launches(counted, fa_routes)
        routes = check_routes(what, routed, counts)
        stats = kept.pop().stats()
        check(stats["policy"] == pol, f"{what}: policy {stats['policy']}")
        check_targets(m["results"], {w.rid: w.target for w in work_j}, what)
        check_tick_launches(what, counts, stats, L)
        tails = trace.class_tails(m, work_j, slos_j)
        serves[what] = {k: m[k] for k in ("wall_time_s", "tokens_per_s", "decode_steps",
                                          "tokens_per_step", "latency_mean", "latency_p90",
                                          "ttft_p50", "ttft_p95", "itl_p50", "itl_p95")}
        serves[what].update(class_tails=tails, launches={k: n for k, n in counts.items() if n},
                            routes=routes, counters=log_counters(what, stats))
        new_s[what] = time.perf_counter() - t1
        log(f"serve {what}: wall {m['wall_time_s']:.2f} s, {m['tokens_per_s']:.1f} tokens/s "
            f"end to end, {m['decode_steps']} decode steps; ticks: ttft p50 "
            f"{m['ttft_p50']:.2f} p95 {m['ttft_p95']:.2f}, itl p50 {m['itl_p50']:.2f} p95 "
            f"{m['itl_p95']:.2f}; class tails {tails}")
        torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - T0:.0f} s] served (h)-(j) in {time.perf_counter() - t0:.1f} s")
    return {"work_h": work_h, "work_i": work_i, "sys_prompt": sys_prompt}


def parity_rest(T, cfg, params, rest: dict, vocab: int, report: dict, new_s: dict) -> None:
    """Phase 5's checks of the rest of the tick: (h), its copy-on-write
    probe and (i) in float32 through ``tick_parity`` (``cfg``, ``params``:
    the parity depth), then the sampler on the card against the CPU."""
    from repro_torch.serving import engine as teng, prng

    work_h, work_i, sys_prompt = rest["work_h"], rest["work_i"], rest["sys_prompt"]
    serving_p = T.ServingCfg(num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64)
    for what, sv, off, drive in (
            ("shared", dataclasses.replace(serving_p, share_prefix=True, defrag_every=4),
             dict(share_prefix=False, defrag_every=0),
             lambda eng: serve_timed(eng, T, templated_requests(T, work_h))[:2]),
            ("shared cow", dataclasses.replace(serving_p, share_prefix=True),
             dict(share_prefix=False),
             lambda eng: cow_probe(T, eng, sys_prompt, vocab)),
            ("speculative", dataclasses.replace(serving_p, spec_len=4, spec_ngram=3),
             dict(spec_len=0), lambda eng: serve_timed(eng, T, loopy_requests(T, work_i))[:2])):
        t1 = time.perf_counter()
        report["parity"][what] = tick_parity(T, cfg, params, what, sv, off, drive)
        new_s[f"parity {what}"] = time.perf_counter() - t1
        log(f"[{time.perf_counter() - T0:.0f} s] parity {what} in "
            f"{new_s[f'parity {what}']:.1f} s")
    t1 = time.perf_counter()
    report["sampler"] = sampler_parity(teng, prng)
    new_s["sampler"] = time.perf_counter() - t1
    report["new_phase_s"] = new_s
    log(f"[{time.perf_counter() - T0:.0f} s] the rest of the tick checked; seconds of the "
        f"added phases: " + ", ".join(f"{k} {v:.1f}" for k, v in new_s.items()))


# ------------------------------------------- phase 4: the replica router (r)

ROUTER_REPLICAS = 2
# the reference fault tests' probe settings
ROUTER_PROBES = dict(probe_interval=2, probe_failures=2, probe_backoff=2, auto_drain=True)
ROUTER_CRASH = (16, 4)      # (r2): a crash window on replica 1's fault clock (tick, duration)
ROUTER_PARITY_DEPTH = 2     # layers of (r)'s f32 parity (of 24; cut from PARITY_DEPTH for time)


def tree_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for x in tree for t in tree_leaves(x)]


def router_requests(T, vocab: int):
    """(r)'s 16 requests: (a)'s 8 and 8 more made the same way from the next
    seed (prompts of 64-512 seeded tokens, 64 new each); every third
    sampled (temperature 0.8, top-k 50, seed 100 + rid), the rest greedy;
    two arrivals a tick."""
    base = make_requests(T, vocab) + make_requests(T, vocab, SEED + 1)
    out = []
    for rid, r in enumerate(base):
        sp = (T.SamplingParams(temperature=0.8, top_k=50, seed=100 + rid,
                               max_tokens=r.max_new_tokens) if rid % 3 == 0
              else T.SamplingParams(max_tokens=r.max_new_tokens))
        out.append(T.ServeRequest(prompt=r.prompt, rid=rid, sampling=sp, arrival=float(rid // 2)))
    return out


def crash_plan():
    """(r2)'s fault plan of replica 1."""
    from repro_torch.serving.faults import FaultEvent, FaultPlan

    return FaultPlan((FaultEvent(ROUTER_CRASH[0], "crash", ROUTER_CRASH[1]),))


def sampled_rids(reqs) -> set:
    return {r.rid for r in reqs if r.sampling.temperature > 0}


def router_run(T, cfg, params, serving, reqs, plans=None, rebalance=False) -> dict:
    """One serve of ``reqs`` through a ReplicaRouter of ROUTER_REPLICAS
    replicas on (a)'s arena with the probe settings, least-loaded placement
    and fault ``plans``, tick by tick with a device sync around each tick.
    Keeps every output event, each tick's (ms, rows decoded, a chunk ran, a
    decode ran), each auto-drain's fall of ``torch.cuda.memory_allocated()``
    beside the drained replica's arena bytes, and, with ``rebalance``, moves
    one decoding and one mid-prefill request of replica 0 to replica 1 at
    the first tick that has both."""
    sv = dataclasses.replace(serving, **ROUTER_PROBES)
    mem0 = torch.cuda.memory_allocated()
    from repro_torch.serving.router import ReplicaRouter

    router = ReplicaRouter(cfg, params, num_replicas=ROUTER_REPLICAS, serving=sv,
                           placement="load", fault_plans=plans, device=DEVICE)
    built = torch.cuda.memory_allocated() - mem0
    drains, moved = [], []
    auto_drain = router._auto_drain

    def watched_drain(i):  # the memory right before and right after the drain
        before = torch.cuda.memory_allocated()
        auto_drain(i)
        drains.append({"replica": i, "freed": before - torch.cuda.memory_allocated(),
                       "arena_bytes": router.stats()["per_replica"][i]["arena_bytes_total"]})

    router._auto_drain = watched_drain
    router.reset(T.GenerationConfig())
    for r in reqs:
        router.add_request(r)
    events, ticks = [], []
    t_all = time.perf_counter()
    after = router.stats()
    while router.has_unfinished():
        before = after
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        router.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        after = router.stats()
        events += router.pending_outputs()
        rows = after["generated_tokens"] - before["generated_tokens"]
        ticks.append((ms, rows, after["prefill_chunks"] > before["prefill_chunks"],
                      after["decode_steps"] > before["decode_steps"]))
        if rebalance and not moved:
            rows0 = [q for q in router.engines[0]._st.sched.occupied()
                     if router.replica_of(q.rid) == 0]
            dec = [q.rid for q in rows0 if q.state == "running"]
            pre = [q.rid for q in rows0 if q.state == "prefilling"]
            if dec and pre:
                moved = [dec[0], pre[0]]
                check(all(router.rebalance(rid, 1) for rid in moved),
                      f"router: rebalance of {moved} refused")
    wall = time.perf_counter() - t_all
    return {"router": router, "built_bytes": built, "events": events, "ticks": ticks,
            "wall": wall, "drains": drains, "moved": moved, "results": router.results(),
            "stats": router.stats()}


def check_exactly_once(what: str, run: dict, reqs) -> None:
    """Every rid in ``results()`` once with its 64 tokens; its events the
    gapless indices 0-63 once each with its tokens, and one finishing
    event; no page leaked on a live replica."""
    results, events = run["results"], run["events"]
    check(set(results) == {r.rid for r in reqs}, f"{what}: rids {sorted(results)}")
    for r in reqs:
        toks = list(results[r.rid]["tokens"])
        mine = [e for e in events if e.rid == r.rid]
        got = sorted((e.index, e.token) for e in mine if e.token >= 0)
        check(len(toks) == r.sampling.max_tokens and got == list(enumerate(toks)),
              f"{what}: request {r.rid}: {len(toks)} tokens, events {[i for i, _ in got]}")
        check(sum(e.finished for e in mine) == 1, f"{what}: request {r.rid} finished "
              f"{sum(e.finished for e in mine)} times")
    for i, eng in enumerate(run["router"].engines):
        if eng._st is not None:
            leaked = eng.stats()["dense_pages_leaked"]
            check(leaked == 0, f"{what}: replica {i} leaked {leaked} pages")


def router_metrics(what: str, run: dict) -> dict:
    """The router's step times (every tick, and the decode-only ones), its
    decode and end-to-end rates, and the reference's tokens_per_step."""
    ticks, stats, wall = run["ticks"], run["stats"], run["wall"]
    all_ms = [ms for ms, *_ in ticks]
    pure = [(ms, rows) for ms, rows, chunk, dec in ticks if dec and not chunk]
    out = {"router_ticks": len(ticks), "decode_steps": stats["decode_steps"],
           "decode_steps_max": stats["decode_steps_max"],
           "prefill_chunks": stats["prefill_chunks"],
           "step_ms_median": float(np.median(all_ms)),
           "step_ms_p90": float(np.percentile(all_ms, 90)),
           "pure_decode_ticks": len(pure),
           "decode_step_ms_median": float(np.median([ms for ms, _ in pure])) if pure else None,
           "decode_tokens_per_s": (sum(r for _, r in pure) / sum(ms for ms, _ in pure) * 1e3
                                   if pure else None),
           "generated_tokens": stats["generated_tokens"], "serve_wall_s": wall,
           "end_to_end_tokens_per_s": stats["generated_tokens"] / wall,
           "tokens_per_step": stats["tokens_per_step"],
           "arena_bytes": stats["arena_bytes_total"],
           "counters": {k: stats[k] for k in ("auto_drains", "recoveries", "migrated_requests",
                                               "rebalanced", "backlog", "timeouts", "shed")}}
    log(f"serve {what}: {len(ticks)} router ticks ({stats['decode_steps']} replica decode "
        f"steps, {stats['prefill_chunks']} chunks); router step median "
        f"{out['step_ms_median']:.3f} ms (p90 {out['step_ms_p90']:.3f}); decode "
        + (f"{out['decode_tokens_per_s']:.1f} tokens/s over {len(pure)} decode-only ticks; "
           if pure else "none alone; ")
        + f"end to end {out['end_to_end_tokens_per_s']:.1f} tokens/s over {wall:.2f} s; "
        f"stats() tokens_per_step {stats['tokens_per_step']:.3f} (the replicas counted as "
        f"parallel; on one card they tick one after the other); arenas "
        f"{stats['arena_bytes_total'] / 1e9:.3f} GB; counters {out['counters']}")
    return out


def serve_router(T, cfg, params, serving, counted: list, routed: dict, fa_routes: dict,
                 serves: dict, new_s: dict) -> None:
    """Serve (r): the ReplicaRouter over ROUTER_REPLICAS replicas of the
    full-width model on (a)'s arena, (r1) with no fault, (r2) with a crash
    window on replica 1, (r3) with one decoding and one mid-prefill request
    rebalanced from replica 0 to 1. Each with every launch and route count
    set to 0 just before and read just after: B1 alone per replica decode
    step and B2 per replica chunk, L launches each, on the ring and the
    tensor cores; exactly-once delivery and no page leaked. (r1) also: one
    weight copy (built from host leaves, the device grows by at most 1.05
    copies, and every leaf of replica 1 is replica 0's); (r2) the drain,
    the recovery and the fall of device memory by the drained arena."""
    from repro_torch.params import to_device

    L = cfg.num_layers
    reqs = router_requests(T, cfg.vocab_size)
    weight = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    host = {"r1": to_device(params, "cpu")}
    plan = crash_plan()
    for key, what, plans, rebalance in (
            ("r1", "router", None, False),
            ("r2", "router crash", [None, plan], False),
            ("r3", "router rebalance", None, True)):
        t1 = time.perf_counter()
        zero_launches(counted, fa_routes)
        zero_routes(routed)
        run = router_run(T, cfg, host.pop(key, params), serving, reqs, plans, rebalance)
        counts = counted_launches(counted, fa_routes)
        routes = check_routes(what, routed, counts)
        stats, router = run["stats"], run["router"]
        want = {name: 0 for name in counts}
        want.update(paged_decode=L * stats["decode_steps"],
                    paged_prefill=L * stats["prefill_chunks"])
        check(counts == want and want["paged_decode"] > 0 and want["paged_prefill"] > 0,
              f"{what}: launch counts {counts}, want {want}")
        check_exactly_once(what, run, reqs)
        shared = [a.data_ptr() == b.data_ptr() for a, b in
                  zip(tree_leaves(router.engines[0].params),
                      tree_leaves(router.engines[1].params))]
        check(all(shared) and len(shared) == len(tree_leaves(params)),
              f"{what}: replica 1 holds its own copy of {shared.count(False)} weight leaves")
        serves[what] = router_metrics(what, run)
        if key == "r1":
            check(run["built_bytes"] <= 1.05 * weight,
                  f"{what}: building {ROUTER_REPLICAS} replicas took "
                  f"{run['built_bytes'] / 1e9:.3f} GB of device memory for "
                  f"{weight / 1e9:.3f} GB of weights")
            log(f"serve {what}: {ROUTER_REPLICAS} replicas built from host leaves took "
                f"{run['built_bytes'] / 1e9:.4f} GB of device memory, one weight copy is "
                f"{weight / 1e9:.4f} GB; every weight leaf of replica 1 is replica 0's")
            serves[what].update(built_bytes=run["built_bytes"], weight_bytes=weight)
        c = serves[what]["counters"]
        if key == "r2":
            check(c["auto_drains"] == 1 and c["recoveries"] == 1
                  and c["migrated_requests"] >= 1, f"{what}: counters {c}")
            d = run["drains"]
            check(len(d) == 1 and d[0]["replica"] == 1 and d[0]["freed"] >= d[0]["arena_bytes"],
                  f"{what}: auto-drains {d}")
            log(f"serve {what}: the auto-drain of replica 1 freed {d[0]['freed'] / 1e9:.4f} "
                f"GB of device memory, its arenas {d[0]['arena_bytes'] / 1e9:.4f} GB")
            serves[what]["drain"] = d[0]
        if key == "r3":
            check(c["rebalanced"] == 2 and len(run["moved"]) == 2, f"{what}: counters {c}, "
                  f"moved {run['moved']}")
            serves[what]["moved"] = run["moved"]
        serves[what].update(launches={k: n for k, n in counts.items() if n}, routes=routes)
        del run, router
        torch.cuda.empty_cache()
        new_s[what] = time.perf_counter() - t1
        log(f"[{time.perf_counter() - T0:.0f} s] served {what} in {new_s[what]:.1f} s")


def router_parity(T, cfg, params, serving, report: dict, new_s: dict) -> None:
    """(r2) and (r3) in float32 (TF32 off, kernels on; ``cfg``/``params``
    cut to ROUTER_PARITY_DEPTH layers) against one fault-free
    ContinuousServeEngine with (a)'s settings on the same 16 requests:
    sampled streams identical, greedy streams identical but for a first
    divergence below ARGMAX_GAP of the engine's top-2 gap (excused,
    counted)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t1 = time.perf_counter()
    reqs = router_requests(T, cfg.vocab_size)
    eng = T.ContinuousServeEngine(cfg, params, serving=serving, device=DEVICE)
    gaps = {}
    watch_gaps(eng, gaps)
    ref = {rid: r["tokens"] for rid, r in eng.serve(reqs)[0].items()}
    del eng
    sampled = sampled_rids(reqs)
    plan = crash_plan()
    for what, plans, rebalance in (("router crash", [None, plan], False),
                                   ("router rebalance", None, True)):
        run = router_run(T, cfg, params, serving, reqs, plans, rebalance)
        got = {rid: r["tokens"] for rid, r in run["results"].items()}
        for rid in sorted(sampled):
            check(np.array_equal(got[rid], ref[rid]),
                  f"parity {what}: sampled request {rid} differs from the engine's")
        greedy = {r.rid: r.sampling.max_tokens for r in reqs if r.rid not in sampled}
        same = compare_streams(what, {True: got, False: ref}, gaps, greedy,
                               names=("router", "engine"))
        c = run["stats"]
        report["parity"][what] = {"sampled_identical": len(sampled),
                                  "greedy_identical": same, "greedy": len(greedy),
                                  "auto_drains": c["auto_drains"], "recoveries": c["recoveries"],
                                  "migrated_requests": c["migrated_requests"],
                                  "rebalanced": c["rebalanced"]}
        log(f"parity {what}: {len(sampled)}/{len(sampled)} sampled streams identical to the "
            f"engine's; counters {report['parity'][what]}")
        del run
        torch.cuda.empty_cache()
    new_s["parity router"] = time.perf_counter() - t1
    log(f"[{time.perf_counter() - T0:.0f} s] parity router in {new_s['parity router']:.1f} s")


# ------------------------------------------------------ phase 9: training

TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_STEPS = 12            # (t1): AdamW steps at full width
TRAIN_SHAPE = (4, 2048)     # (t1): rows, tokens a row (past 1024: flash attention)
TRAIN_LR = (1e-3, 2)        # (t1): cosine_schedule's peak lr and warmup steps
BF16_PEAK = 989e12          # H100 SXM dense bf16 FLOP/s at 700 W (NVIDIA data sheet)
FLASH_BWD_TOL = 5e-5        # (t2): flash gradients vs dense autograd, each over its own largest
TRAIN_TOL = 1e-5            # (t3): card vs CPU, each tensor over its own largest |value|
MICRO_TOL = 1e-5            # (t3): remat, microbatches, resume on the card, the same measure
PARITY_LR = 0.5             # (t3): the SGD probe's lr in the card-vs-CPU step
PARITY_BLOCKS = 3           # (t3): blocks of the smoke config (stacked optimizer leaves)
REL_FLOOR = 1e-12           # the least scale of a tensor in rel_err and step_err
BF16_ULP = 2.0 ** -7        # a bf16 step, relative (Adafactor's first moment)
FLASH_BWD_CASES = (  # what, B, T, S, H, KV, Dh, Dv, causal, q_offset
    ("qwen causal", 1, 2048, 2048, 16, 16, 64, 64, True, 0),
    ("qwen non-causal", 1, 2048, 2048, 16, 16, 64, 64, False, 0),
    ("qwen T!=S q_offset", 1, 1536, 2048, 16, 16, 64, 64, True, 512),
    ("jamba causal", 1, 2048, 2048, 64, 8, 128, 128, True, 0),
    ("jamba T!=S q_offset", 1, 1000, 2048, 64, 8, 128, 128, True, 1048),
    ("mla causal", 1, 2048, 2048, 16, 16, 192, 128, True, 0),
    ("cross non-causal", 2, 512, 1600, 32, 8, 128, 128, False, 0),
)


def rel_err(got, want) -> float:
    """Over two lists of tensors, the largest max |got - want| over the
    tensor's own largest |want| (at least REL_FLOOR)."""
    return max(float((g.double().cpu() - w.double().cpu()).abs().max())
               / max(REL_FLOOR, float(w.abs().max())) for g, w in zip(got, want) if w.numel())


def step_err(got, want, old) -> float:
    """Two steps from the same tensors ``old``: over the tensors, the largest
    max |got - want|, less one float32 rounding step of the tensor's largest
    value (each side rounds its new values to float32), over the largest
    change |want - old|. A step that changes nothing gives about 1."""
    out = 0.0
    for g, w, o in zip(got, want, old):
        g, w, o = (t.double().cpu() for t in (g, w, o))
        d = float((g - w).abs().max()) - 2.0 ** -23 * float(w.abs().max())
        out = max(out, max(0.0, d) / max(REL_FLOOR, float((w - o).abs().max())))
    return out


def bf16_err(got, want, allow) -> tuple[float, float]:
    """bf16 values (or values made from them) that may round the other way
    where the inputs differ in the last float32 bit: (the share of elements
    off by more than TRAIN_TOL of their tensor's largest |want|, the
    largest error over that plus ``allow``, the tensor's allowance)."""
    off, n, worst = 0, 0, 0.0
    for g, w, a in zip(got, want, allow):
        g, w = g.double().cpu(), w.double().cpu()
        tol = TRAIN_TOL * max(REL_FLOOR, float(w.abs().max()))
        off += int(((g - w).abs() > tol).sum())
        n += w.numel()
        worst = max(worst, float((g - w).abs().max()) / (tol + a))
    return off / n, worst


def flash_backward(report: dict) -> None:
    """(t2): the flash autograd.Function's gradients against autograd
    through dense_attention, both on the card in float32."""
    from repro_torch.core import flash_ref
    from repro_torch.core.attention import dense_attention

    gen = torch.Generator(device=DEVICE).manual_seed(SEED)
    out = report["train"]["flash_backward"] = {}
    for what, B, T, S, H, KV, Dh, Dv, causal, off in FLASH_BWD_CASES:
        q, k, v = (torch.randn(shape, generator=gen, device=DEVICE)
                   for shape in ((B, T, H, Dh), (B, S, KV, Dh), (B, S, KV, Dv)))
        w = torch.randn((B, T, H, Dv), generator=gen, device=DEVICE)
        scale = Dh ** -0.5

        def grads(fn):
            qq, kk, vv = (t.detach().requires_grad_(True) for t in (q, k, v))
            return torch.autograd.grad((fn(qq, kk, vv) * w).sum(), (qq, kk, vv))

        def flash(a, b, c):
            return flash_ref.flash_attention(a, b, c, scale, causal, off)

        def dense(a, b, c):
            return dense_attention(a, b, c, scale, causal=causal, q_offset=off)

        err = rel_err(grads(flash), grads(dense))
        out[what] = {"shape": [B, T, S, H, KV, Dh, Dv, causal, off], "rel_err": err,
                     "flash_ms": cuda_ms(lambda: grads(flash), 3),
                     "dense_ms": cuda_ms(lambda: grads(dense), 3)}
        log(f"(t2) flash backward {what} (B {B}, T {T}, S {S}, H {H} over {KV}, Dh {Dh}, "
            f"Dv {Dv}): dq, dk, dv within {err:.3e} of dense autograd's (x each one's "
            f"largest |grad|; gate {FLASH_BWD_TOL}); forward+backward "
            f"{out[what]['flash_ms']:.2f} ms "
            f"(plain flash) vs {out[what]['dense_ms']:.2f} ms (dense), float32")
        check(err <= FLASH_BWD_TOL, f"(t2) {what}: flash gradients off by {err:.3e}")
        del q, k, v, w
    torch.cuda.empty_cache()


def train_full(T, smi: str, zero, counts, report: dict) -> None:
    """(t1): full-width qwen1.5-0.5b in bf16, random weights from SEED,
    AdamW on cosine_schedule, remat, SyntheticLMData at TRAIN_SHAPE. Gates:
    every loss finite, the loss falls, no kernel wrapper or route counter
    of B1-B10 moves (the reference's training launches no Pallas kernel)."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.optim import adamw, cosine_schedule
    from repro_torch.params import init_params
    from repro_torch.train.step import TrainStepCfg, make_train_step

    cfg = T.get_config(TRAIN_ARCH)
    check(cfg.param_dtype == torch.bfloat16 and cfg.num_blocks == 24 and cfg.d_model == 1024,
          f"(t1) {TRAIN_ARCH} is not at its published widths in bf16")
    B, S = TRAIN_SHAPE
    opt = adamw(cosine_schedule(TRAIN_LR[0], TRAIN_LR[1], TRAIN_STEPS))
    step_fn = make_train_step(cfg, opt, TrainStepCfg(microbatches=1, remat=True))
    data = SyntheticLMData(cfg, ShapeCfg("train", S, B, "train"), DataConfig(seed=SEED))
    batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(s).items()}
               for s in range(TRAIN_STEPS)]
    params = init_params(cfg, SEED, DEVICE)
    n = n_params(params)
    opt_state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()  # weights, moments, batches, what earlier phases hold
    zero()
    losses, secs = [], []
    for s in range(TRAIN_STEPS):
        t = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, s, batches[s])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        losses.append(float(m["loss"]))
    launched = {k: c for k, c in counts().items() if c}
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(secs[1:])
    # one more step under torch.profiler (CUDA activity only): where the
    # device time of a step goes
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    extra = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(TRAIN_STEPS).items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, opt_state, _ = step_fn(params, opt_state, TRAIN_STEPS, extra)
        torch.cuda.synchronize()
    kernels = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.device_time_total > 0),
                     key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kernels)
    gemm = sum(ms for k, ms, _ in kernels
               if any(g in k for g in ("gemm", "nvjet", "cutlass", "xmma")))
    L, H, Dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
    flops = 6 * n * B * S + 3 * L * B * H * (Dh + Dh) * S * S  # causal attention: half
    r = report["train"]["full"] = {
        "arch": TRAIN_ARCH, "params": n, "batch": [B, S], "steps": TRAIN_STEPS,
        "losses": losses, "step_s": secs, "median_step_s": step_s,
        "tokens_per_s": B * S / step_s, "peak_bytes": peak, "allocated_before": base,
        "model_flops": flops,
        "bf16_peak_share": flops / step_s / BF16_PEAK, "launches": launched, "card": smi,
        "profile": {"device_busy_ms": busy, "busy_share": busy / (step_s * 1e3),
                    "gemm_ms": gemm, "kernels": len(kernels),
                    "launches": sum(n for _, _, n in kernels),
                    "top_kernels": [{"name": k, "ms": ms, "count": n}
                                    for k, ms, n in kernels[:12]]}}
    log(f"(t1) {TRAIN_ARCH} train, {n / 1e6:.1f} M parameters bf16, {B} x {S} tokens a step, "
        f"remat, AdamW: losses {', '.join(f'{x:.4f}' for x in losses)}")
    log(f"(t1) [{smi}] step median {step_s * 1e3:.3f} ms (steps 2-{TRAIN_STEPS}; first "
        f"{secs[0] * 1e3:.3f} ms), {r['tokens_per_s']:.1f} training tokens/s, peak device "
        f"memory {peak / 1e9:.3f} GB ({base / 1e9:.3f} GB allocated before the first step), "
        f"{r['bf16_peak_share'] * 100:.2f} % of the bf16 peak "
        f"({flops / 1e12:.2f} TFLOP a step: 6 N tokens + causal attention, remat's "
        "recompute not counted)")
    log(f"(t1) profile of one more step: device busy {busy:.2f} ms of the {step_s * 1e3:.2f} "
        f"ms median step ({busy / (step_s * 1e3):.1%}), {r['profile']['launches']} kernel "
        f"launches; GEMMs {gemm:.2f} ms")
    for k, ms, n in kernels[:8]:
        log(f"(t1) profile:   {ms:9.3f} ms {n:6d}x {k[:100]}")
    check(all(math.isfinite(x) for x in losses), f"(t1) a loss is not finite: {losses}")
    check(losses[-1] < losses[0] and sum(losses[-3:]) < sum(losses[:3]),
          f"(t1) the loss did not fall: {losses}")
    check(not launched, f"(t1) training launched attention kernels: {launched}")
    del params, opt_state, batches
    torch.cuda.empty_cache()


def sgd_probe(lr: float):
    """A plain SGD (``-lr * g``) as an Optimizer: the train step's float32
    gradient accumulation reaches the parameters as it is (AdamW's first
    step divides each gradient by its own magnitude, so an element whose
    gradient is near eps, 1e-8, turns a last-ulp difference into one of up
    to twice the lr)."""
    from repro_torch.optim import Optimizer
    from repro_torch.params import tree_map

    return Optimizer(init=lambda p: (),
                     update=lambda g, st, p, step: (tree_map(lambda x: -lr * x, g), st))


def train_parity(T, M, report: dict) -> None:
    """(t3): qwen1.5-0.5b's smoke config at float32 and PARITY_BLOCKS blocks,
    every error a tensor's own (rel_err, step_err). On the card against the
    CPU from the same weights and batch: the loss and the gradients; one
    make_train_step step under an SGD probe at lr PARITY_LR, its change of
    the parameters (the step's gradients reach them as they are; under
    AdamW's first step g / (|g| + eps) a gradient near 0 that differs in
    its last bits flips sign); two AdamW and two Adafactor updates of the
    same seeded gradients, updates and every state tensor (the stacked
    leaves: Adafactor factors a norm scale's (num_blocks, d) leaf; its
    first moment is bf16 and may round the other way for a few elements,
    held within one bf16 step). Each within TRAIN_TOL. Then on the card:
    remat against none (gradients), two microbatches against one (the SGD
    probe), and 2 steps, a save, a restore and 2 more against 4 straight
    (AdamW; deterministic algorithms on: the embedding's backward otherwise
    sums with atomics), each within MICRO_TOL."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager, split_train_state, train_state
    from repro_torch.configs import ShapeCfg
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.optim import adafactor, adamw
    from repro_torch.params import (init_params, ref_leaves, ref_unflatten, stack_blocks,
                                    to_device, tree_map)
    from repro_torch.train.step import TrainStepCfg, make_train_step

    cfg = dataclasses.replace(T.smoke_config(T.ARCHS[TRAIN_ARCH]), dtype="float32",
                              num_blocks=PARITY_BLOCKS)
    cpu = init_params(cfg, SEED, device="cpu")
    card = to_device(cpu, DEVICE)
    data = SyntheticLMData(cfg, ShapeCfg("train", 64, 4, "train"), DataConfig(seed=SEED))
    host = [{k: torch.from_numpy(v) for k, v in data.batch(s).items()} for s in range(4)]
    dev = [{k: v.to(DEVICE) for k, v in b.items()} for b in host]
    out = report["train"]["parity"] = {}

    def grads(params, batch, remat=True):
        leaves = [t.detach().requires_grad_(True) for t in ref_leaves(params)]
        loss, _ = M.loss_fn(cfg, ref_unflatten(params, leaves), batch, remat=remat)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    def leaves(tree):
        return ref_leaves(stack_blocks(tree))

    def loss_rel(a, b):
        return abs(float(a) - float(b)) / abs(float(b))

    (l_cpu, g_cpu), (l_card, g_card) = grads(cpu, host[0]), grads(card, dev[0])
    out["loss_card_vs_cpu"] = loss_rel(l_card, l_cpu)
    out["grads_card_vs_cpu"] = rel_err(g_card, g_cpu)
    step = make_train_step(cfg, sgd_probe(PARITY_LR), TrainStepCfg())
    p_cpu, _, m_cpu = step(cpu, (), 0, host[0])
    p_card, _, m_card = step(card, (), 0, dev[0])
    out["step_loss_card_vs_cpu"] = loss_rel(m_card["loss"], m_cpu["loss"])
    out["step_card_vs_cpu"] = step_err(leaves(p_card), leaves(p_cpu), leaves(cpu))
    # the optimizers alone, on the same seeded gradients (global norm 4:
    # the clip acts), two updates each
    gen = torch.Generator().manual_seed(SEED)
    g_host = []
    for _ in range(2):
        g = tree_map(lambda t: torch.randn(t.shape, generator=gen), cpu)
        norm = math.sqrt(sum(float(x.double().square().sum()) for x in ref_leaves(g)))
        g_host.append(tree_map(lambda x, c=4.0 / norm: x * c, g))
    peak = 1e-2
    for name, make in (("adamw", adamw), ("adafactor", adafactor)):
        opt = make(peak, weight_decay=0.1)
        res = {}
        for where, params in (("cpu", cpu), ("card", card)):
            state, us, ms, rest = opt.init(params), [], [], []
            for i, g in enumerate(g_host):
                u, state = opt.update(to_device(g, params["embed"]["tok"].device), state,
                                      params, i)
                us += leaves(u)
                ms += ref_leaves(state[0])
                rest += [x for f in state[1:] for x in ref_leaves(f)]
            res[where] = (us, ms, rest, state)
        (u_cpu, m_cpu, r_cpu, _), (u_card, m_card, r_card, st) = res["cpu"], res["card"]
        if name == "adamw":
            out["adamw_updates_card_vs_cpu"] = rel_err(u_card, u_cpu)
            out["adamw_state_card_vs_cpu"] = rel_err(m_card + r_card, m_cpu + r_cpu)
            continue
        # a bf16 moment may round one step the other way; an update moves by
        # lr times that step (lr at most peak)
        m_allow = [BF16_ULP * float(w.abs().max()) for w in m_cpu]
        out["adafactor_m_off_share"], out["adafactor_m_card_vs_cpu"] = bf16_err(
            m_card, m_cpu, m_allow)
        out["adafactor_updates_off_share"], out["adafactor_updates_card_vs_cpu"] = bf16_err(
            u_card, u_cpu, [peak * a for a in m_allow])
        out["adafactor_factored_card_vs_cpu"] = rel_err(r_card, r_cpu)
        out["adafactor_norm_scale_moments"] = {
            k: list(getattr(st, k)["blocks"][0]["norm1"]["scale"].shape)
            for k in ("v_row", "v_col")}
    (l1, g1), (l0, g0) = grads(card, dev[0], remat=True), grads(card, dev[0], remat=False)
    out["remat_vs_none"] = max(loss_rel(l1, l0), rel_err(g1, g0))
    probe = {k: make_train_step(cfg, sgd_probe(PARITY_LR), TrainStepCfg(microbatches=k))(
        card, (), 0, dev[0]) for k in (1, 2)}
    out["microbatches_2_vs_1"] = max(
        loss_rel(probe[2][2]["loss"], probe[1][2]["loss"]),
        step_err(leaves(probe[2][0]), leaves(probe[1][0]), leaves(card)))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        opt = adamw(1e-3)
        step = make_train_step(cfg, opt, TrainStepCfg())

        def run(params, state, steps):
            for s in steps:
                params, state, m = step(params, state, s, dev[s])
            return params, state, float(m["loss"])

        straight = run(card, opt.init(card), range(4))
        half = run(card, opt.init(card), range(2))
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d)
            mgr.save(2, train_state(half[0], half[1]))
            params, state = split_train_state(mgr.restore(2, train_state(card, opt.init(card))))
            mgr.close()
        resumed = run(params, state, range(2, 4))
    finally:
        torch.use_deterministic_algorithms(False)
    out["resume_loss_rel"] = abs(resumed[2] - straight[2]) / abs(straight[2])
    out["resume_vs_straight"] = max(
        step_err(leaves(resumed[0]), leaves(straight[0]), leaves(card)),
        rel_err(ref_leaves(resumed[1]), ref_leaves(straight[1])))
    log(f"(t3) {cfg.name} float32 at {PARITY_BLOCKS} blocks, card vs CPU (each tensor over "
        f"its own largest): loss {out['loss_card_vs_cpu']:.3e}, gradients "
        f"{out['grads_card_vs_cpu']:.3e}; SGD-probe step (lr {PARITY_LR}) loss "
        f"{out['step_loss_card_vs_cpu']:.3e}, change of the parameters "
        f"{out['step_card_vs_cpu']:.3e}; AdamW updates {out['adamw_updates_card_vs_cpu']:.3e}, "
        f"moments {out['adamw_state_card_vs_cpu']:.3e}; Adafactor factored moments "
        f"{out['adafactor_factored_card_vs_cpu']:.3e} (norm1's scale: "
        f"{out['adafactor_norm_scale_moments']}), "
        f"bf16 moment {out['adafactor_m_card_vs_cpu']:.3f} of its allowance "
        f"({out['adafactor_m_off_share']:.2e} of elements past {TRAIN_TOL}), updates "
        f"{out['adafactor_updates_card_vs_cpu']:.3f} ({out['adafactor_updates_off_share']:.2e});"
        f" gate {TRAIN_TOL}")
    log(f"(t3) on the card: remat vs none {out['remat_vs_none']:.3e}, 2 microbatches vs 1 "
        f"{out['microbatches_2_vs_1']:.3e}, resume vs straight {out['resume_vs_straight']:.3e}"
        f" (loss rel {out['resume_loss_rel']:.3e}); gates {MICRO_TOL}, loss 1e-5")
    for key in ("loss_card_vs_cpu", "grads_card_vs_cpu", "step_loss_card_vs_cpu",
                "step_card_vs_cpu", "adamw_updates_card_vs_cpu", "adamw_state_card_vs_cpu",
                "adafactor_factored_card_vs_cpu"):
        check(out[key] <= TRAIN_TOL, f"(t3) {key} {out[key]:.3e} past {TRAIN_TOL}")
    for key in ("adafactor_m", "adafactor_updates"):
        check(out[f"{key}_card_vs_cpu"] <= 1.0 and out[f"{key}_off_share"] <= 1e-3,
              f"(t3) {key}: {out[f'{key}_card_vs_cpu']:.3f} of its allowance, "
              f"{out[f'{key}_off_share']:.2e} of elements past {TRAIN_TOL}")
    check(out["adafactor_norm_scale_moments"] == {"v_row": [PARITY_BLOCKS],
                                                   "v_col": [cfg.d_model]},
          f"(t3) Adafactor did not factor the stacked norm scale: "
          f"{out['adafactor_norm_scale_moments']}")
    for key in ("remat_vs_none", "microbatches_2_vs_1", "resume_vs_straight"):
        check(out[key] <= MICRO_TOL, f"(t3) {key} {out[key]:.3e} past {MICRO_TOL}")
    check(out["resume_loss_rel"] <= 1e-5, f"(t3) resumed loss off by {out['resume_loss_rel']}")


def train_phase(T, M, smi: str, counted: list, routed: dict, fa_routes: dict,
                report: dict) -> None:
    """Phase 9: training. (t1) full-width qwen1.5-0.5b, (t2) the flash
    backward at served heads, (t3) the smoke config's step on the card
    against the CPU, remat, microbatches and a checkpoint resume. ``routed``
    holds every kernel's route counters, ``fa_routes`` B8's."""
    t0 = time.perf_counter()
    report["train"] = {}

    def zero():
        zero_launches(counted, fa_routes)
        zero_routes(routed)

    def counts():
        return {**counted_launches(counted, fa_routes),
                **{f"{name}/{r}": n for name, (c, _) in routed.items() for r, n in c.items()}}

    train_full(T, smi, zero, counts, report)
    flash_backward(report)
    train_parity(T, M, report)
    report["train"]["seconds"] = time.perf_counter() - t0
    log(f"[{time.perf_counter() - T0:.0f} s] phase 9 (training) took "
        f"{report['train']['seconds']:.1f} s")


# ------------------------------------------------ phase 10: tune and launch

TUNE_SHAPE = (4, 1, 16)      # KV, G, Dh of the tuner's smoke model (qwen1.5-0.5b's smoke heads)
TUNE_PAGES = (4, 8)          # the tuner's page sizes that phase 3 does not sweep (it sweeps 16)
TUNE_CHUNKS = (4, 8, 32, 64)  # the tuner's chunk lengths (chunk_pages x page_size) beside 16
TUNE_BUDGET = 12             # (u3): evaluations of the tune entry point's --smoke search
TUNE_GENOMES = (  # (u2): what, the knobs set apart from DEFAULT_GENOME, the space's budget rows
    ("default", {}, None),
    ("spec 2 slo", {"spec_len": 2, "policy": "slo"}, None),
    ("tiered pages 4", {"enable_escalation": True, "page_size": 4}, None),
    ("chunks 4 pages 16", {"chunk_pages": 4, "page_size": 16}, None),
    # the tuner's arena holds 4 full-length rows, so its tiered genomes never
    # cross the low watermark on its trace and admit nothing into the CPQ
    # tier: this one is served from one row's arena, where rows are admitted
    # into the CPQ tier in chunks of 4 (B6 at pages of 4)
    ("tiered pages 4, one row's arena", {"enable_escalation": True, "page_size": 4,
                                         "chunk_pages": 1, "low_watermark": 0.4}, 1),
)
LAUNCH_SHAPE = ("--batch", "8", "--prompt", "64", "--new", "32")
PRESETS = ("default", "latency", "throughput", "energy")
PAGED = ("paged_decode", "paged_prefill")


def tuner_calls(long_len: int, page: int) -> tuple:
    """(offset, valid, C) of the chunks (u1) runs over a long row at each
    of TUNE_CHUNKS: a first chunk, valid < C at a mid-page offset, a chunk
    far in and the row's last tokens."""
    out = []
    for C in TUNE_CHUNKS:
        out += [(0, C, C), (page + page // 2, max(1, C - 3), C), (long_len - C - 1, C, C),
                (long_len - 3, 3, C)]
    return tuple(out)


def sweep_tuner(ops, cpq_ops, errs: dict) -> None:
    """(u1): B1, B2, B5 and B6 against their plain versions at the tuner's
    heads (KV 4, G 1, Dh 16), on pages of 4 and 8 and chunks of 4-64 rows,
    on phase 3's layouts, each call on its route, under phase 3's
    tolerances."""
    KV, G, Dh = TUNE_SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).removeprefix("torch.")
        for page in TUNE_PAGES:
            tag = f"{dname} KV={KV} G={G} Dh={Dh} page={page} chunks={TUNE_CHUNKS}"
            calls_of = lambda n, page=page: tuner_calls(n, page)  # noqa: E731
            e_dec, e_pre = sweep(ops, dtype, KV, G, Dh, page=page, calls_of=calls_of)
            errs["paged_decode"][tag], errs["paged_prefill"][tag] = e_dec, e_pre
            e_cd = e_cp = 0.0
            for bits in (4, 8):
                d, p = sweep_cpq(cpq_ops, dtype, KV, G, Dh, bits, page=page, calls_of=calls_of)
                errs["paged_cpq_decode"][f"{tag} bits={bits}"] = d
                errs["paged_cpq_prefill"][f"{tag} bits={bits}"] = p
                e_cd, e_cp = max(e_cd, d), max(e_cp, p)
            log(f"sweep {tag}: paged_decode {e_dec:.3e} ({ops.decode_route(dtype, Dh, Dh, 64)} "
                f"route), paged_prefill {e_pre:.3e} ({ops.prefill_route(dtype, Dh, Dh)} route), "
                f"paged_cpq_decode {e_cd:.3e} ({cpq_ops.cpq_decode_route(Dh, Dh)} route), "
                f"paged_cpq_prefill {e_cp:.3e} "
                f"({cpq_ops.cpq_prefill_route(dtype, Dh, Dh, CPQ_LEVELS)} route; bits 4 and 8; "
                f"tol {TOL[dtype]})")
            for name in ("paged_decode", "paged_prefill", "paged_cpq_decode", "paged_cpq_prefill"):
                for t, err in errs[name].items():
                    if t.startswith(tag):
                        check(err <= TOL[dtype], f"(u1) {name} {t}: error {err}")


def objective_parity(T, counted: list, routed: dict, fa_routes: dict, report: dict) -> None:
    """(u2): the port's ServingObjective on the card and on the CPU, the
    smoke config at float32 with the same weights, over TUNE_GENOMES:
    objective tuples and metrics identical; B1 and B2 launched by every
    genome on the card, B5 by the tiered ones, B6 by the one served from
    one row's arena (the counts set to 0 just before each evaluation and
    read just after). The objectives depend on scheduling alone (the trace
    never stops at EOS), so each genome's trace is then served once more on
    either side through ``run_trace`` and its greedy streams compared
    (``trace_streams``)."""
    from repro_torch.params import init_params
    from repro_torch.serving.trace import run_trace
    from repro_torch.tuning import DEFAULT_GENOME, KnobSpace, ServingObjective

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(T.smoke_config(T.ARCHS["qwen1.5-0.5b"]), dtype="float32")
    params = init_params(cfg, SEED, "cpu")
    sides = {"card": ServingObjective(cfg, params, device=DEVICE),
             "cpu": ServingObjective(cfg, params, device="cpu")}
    max_len = sides["cpu"].space.max_len
    out = report["tune"]["objective"] = {}
    for what, knobs, rows in TUNE_GENOMES:
        genome = {**DEFAULT_GENOME, **knobs}
        got, streams = {}, {}
        for side, obj in sides.items():
            if rows is not None:
                obj = ServingObjective(cfg, params, space=KnobSpace(max_len=max_len,
                                                                    budget_slots=rows),
                                       device=obj.device)
            zero_launches(counted, fa_routes)
            zero_routes(routed)
            got[side] = obj(genome)
            if side == "card":
                counts = {k: n for k, n in counted_launches(counted, fa_routes).items() if n}
                routes = {name: {r: n for r, n in c.items() if n}
                          for name, (c, _) in routed.items() if any(c.values())}
            run = run_trace(cfg, obj.params, obj.work, obj.space.to_serving(genome),
                            slos=obj.slos, device=obj.device)
            streams[side] = {rid: np.asarray(r["tokens"]) for rid, r in run["results"].items()}
        tiered = genome["enable_escalation"]
        want = set(PAGED) | ({"paged_cpq_decode"} if tiered else set()) | (
            {"paged_cpq_prefill"} if rows is not None else set())
        out[what] = {"objectives": got["card"][0], "metrics": got["card"][1],
                     "launches": counts, "routes": routes}
        log(f"(u2) objective {what}: card {got['card'][0]}, CPU {got['cpu'][0]}; launches on "
            f"the card {counts}, routes {routes}")
        check(got["card"] == got["cpu"],
              f"(u2) {what}: card {got['card']} against CPU {got['cpu']}")
        out[what]["streams_excused"] = trace_streams(cfg, params, sides["cpu"].work, streams,
                                                     what)
        check(want <= set(counts) <= want | {"paged_cpq_prefill"},
              f"(u2) {what}: launches {counts}, want {sorted(want)}")


def trace_streams(cfg, params, work, streams: dict, what: str) -> int:
    """(u2): a trace's greedy streams on the card and on the CPU, by
    request: identical, but for a first divergence where the CPU's top-2
    logit gap is below ARGMAX_GAP. The gap is taken from a dense float32
    forward on the CPU of the prompt and the CPU's tokens before the
    divergence. Returns the number of excused streams."""
    from repro_torch.models import model as M

    excused = 0
    for w in work:
        a, b = streams["card"][w.rid], streams["cpu"][w.rid]
        check(len(a) == len(b), f"(u2) {what}: request {w.rid} lengths {len(a)}, {len(b)}")
        diff = np.flatnonzero(a != b)
        if not len(diff):
            continue
        t = int(diff[0])   # after a divergence the contexts differ: stop there
        seq = torch.as_tensor(np.concatenate([np.asarray(w.prompt), b[:t]])[None],
                              dtype=torch.long)
        with torch.no_grad():
            logits, _ = M.forward_train(cfg, params, {"tokens": seq}, remat=False)
        gap = top2_gap(logits[0, -1]).item()
        log(f"(u2) {what}: request {w.rid} diverges at token {t}: card {a[t]} vs CPU {b[t]}, "
            f"CPU top-2 gap {gap:.3e}")
        check(gap < ARGMAX_GAP, f"(u2) {what}: request {w.rid} token {t} differs at a "
              f"resolvable gap {gap:.3e}")
        excused += 1
    log(f"(u2) {what}: greedy streams card against CPU identical for "
        f"{len(work) - excused}/{len(work)} requests, {excused} near-tie divergences excused")
    return excused


def tune_entry(T, counted: list, routed: dict, fa_routes: dict, report: dict) -> None:
    """(u3): the tune entry point on the card at its default dtype (bf16),
    a --smoke search of TUNE_BUDGET evaluations written to a temporary
    file: its own contract must pass (assertions inside main), B1 and B2
    launch on their bf16 routes, and neither package's committed presets
    file changes."""
    from repro_torch.launch import tune

    root = os.path.dirname(os.path.abspath(__file__))
    committed = [T.ServingCfg.preset_path(),
                 os.path.join(root, "src", "repro", "configs", "serving_presets.json")]

    def digests():
        return [hashlib.sha256(open(p, "rb").read()).hexdigest() if os.path.exists(p) else None
                for p in committed]

    before = digests()
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "presets.json")
        zero_launches(counted, fa_routes)
        zero_routes(routed)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = tune.main(["--budget", str(TUNE_BUDGET), "--smoke", "--out", out])
        seconds = time.perf_counter() - t0
        counts = {k: n for k, n in counted_launches(counted, fa_routes).items() if n}
        with open(out) as f:
            doc = json.load(f)
    text = buf.getvalue()
    for line in text.splitlines():
        if not line.startswith("[tune] eval"):
            log(line)
    runs = sum(line.startswith("[tune] eval") for line in text.splitlines())
    check(rc == 0 and "smoke PASS" in text, "(u3) the tune entry point's --smoke contract")
    check(digests() == before, "(u3) a committed presets file changed")
    check(set(PAGED) <= set(counts), f"(u3) launches {counts}")
    routes = check_routes("(u3) tune", routed, counts)
    report["tune"]["entry"] = {"seconds": seconds, "evaluations": doc["budget"],
                               "engine_runs": runs, "launches": counts, "routes": routes,
                               "trace": doc["trace"], "hypervolume": doc["hypervolume"]}
    log(f"(u3) tune --smoke: {doc['budget']} evaluations ({runs} engine runs) in {seconds:.2f} s "
        f"= {doc['budget'] / seconds:.3f} evaluations/s ({runs / seconds:.3f} engine runs/s); "
        f"launches {counts}")


def launch_runs(tiered: dict) -> tuple:
    """(u4): (what, serve arguments, kernels that must launch, kernels that
    may) of the serve entry point's runs at full width; ``tiered`` says of
    each preset whether it escalates (then B5 launches, and B6 may)."""
    runs = []
    for p in PRESETS:
        cpq = {"paged_cpq_decode"} if tiered[p] else set()
        runs.append((f"preset {p}", ("--continuous", "--preset", p), set(PAGED) | cpq,
                     {"paged_cpq_prefill"} if cpq else set()))
    runs += [
        ("continuous decomposed", ("--continuous", "--mode", "decomposed"),
         {"paged_decomposed_decode", "paged_decomposed_prefill"}, set()),
        ("continuous retrieval", ("--continuous", "--mode", "retrieval"),
         {"paged_proxy_scores", "paged_prefill"}, set()),
        ("continuous cpq", ("--continuous", "--mode", "cpq"),
         {"paged_cpq_decode", "paged_cpq_prefill"}, set()),
        ("static cpq", ("--mode", "cpq"), {"flash_attention", "flash_attention/prompt",
                                           "cpq_decode"}, set()),
        ("replicas 2, faults 0", ("--continuous", "--replicas", "2", "--inject-faults", "0"),
         set(PAGED), set()),
    ]
    return tuple(runs)


def serve_entry(T, smi: str, counted: list, routed: dict, fa_routes: dict,
                report: dict) -> None:
    """(u4): the serve entry point at full width: qwen1.5-0.5b (24 layers,
    random bf16 weights from SEED), 8 prompts of 64 tokens, 32 new. Each
    run's output shape, the kernels it launches (the counts set to 0 just
    before and read just after) and their bf16 routes; the default preset's
    greedy output against a ContinuousServeEngine built here with the same
    ServingCfg, weights and batch; each run's tokens/s."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch import serve
    from repro_torch.params import init_params
    from repro_torch.serving.paged_cache import pages_needed

    tiered = {p: T.ServingCfg.from_preset(p).enable_escalation for p in PRESETS}
    outs, report["tune"]["serve"] = {}, {}
    for what, args, need, may in launch_runs(tiered):
        zero_launches(counted, fa_routes)
        zero_routes(routed)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = serve.main(["--arch", "qwen1.5-0.5b", *LAUNCH_SHAPE, *args])
        seconds = time.perf_counter() - t0
        counts = {k: n for k, n in counted_launches(counted, fa_routes).items() if n}
        torch.cuda.empty_cache()
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(f"(u4) {what}: {line}")
        gen = next(line for line in lines if line.startswith("[serve] generated"))
        tok_s = float(gen.split("(")[-1].split(" tok/s")[0])
        check(out.shape == (8, 32) and out.min() >= 0, f"(u4) {what}: output {out.shape}")
        check(need <= set(counts) <= need | may, f"(u4) {what}: launches {counts}, want "
              f"{sorted(need)}")
        routes = check_routes(f"(u4) {what}", routed, counts)
        check(counts.get("flash_attention", 0) == counts.get("flash_attention/prompt", 0),
              f"(u4) {what}: a flash_attention launch off its prompt route: {counts}")
        outs[what] = out
        report["tune"]["serve"][what] = {"tokens_per_s": tok_s, "seconds": seconds,
                                         "launches": counts, "routes": routes}
        log(f"(u4) {what}: {tok_s:.1f} tokens/s ({smi}); {seconds:.1f} s with the weights' "
            f"init; launches {counts}")
    # the default preset against the engine built here
    cfg = served_config(T)
    params = init_params(cfg, SEED, DEVICE)
    batch = SyntheticLMData(cfg, ShapeCfg("serve", 64, 8, "prefill"),
                            DataConfig(seed=SEED)).batch(0)
    batch.pop("labels")
    n_max = 64 + 32
    base = T.ServingCfg.from_preset("default")
    serving = T.ServingCfg.from_preset(
        "default", num_pages=base.num_slots * pages_needed(n_max, base.page_size) + 1,
        max_blocks_per_slot=pages_needed(n_max, base.page_size),
        prefill_bucket=base.prefill_chunk or base.page_size)
    eng = T.ContinuousServeEngine(cfg, params, serving=serving, device=DEVICE)
    want, _ = eng.generate(batch, T.GenerationConfig(max_new_tokens=32, seed=SEED))
    del eng, params
    torch.cuda.empty_cache()
    check(np.array_equal(outs["preset default"], want),
          "(u4) the default preset's greedy output differs from the engine's")
    log("(u4) preset default: greedy output identical to a ContinuousServeEngine built with "
        "the same ServingCfg, weights and batch")


def tune_phase(T, ops, cpq_ops, errs: dict, smi: str, counted: list, routed: dict,
               fa_routes: dict, report: dict) -> None:
    """Phase 10: the tuner's kernel shapes (u1), the objective card against
    CPU (u2), the tune entry point (u3) and the serve entry point (u4)."""
    t0 = time.perf_counter()
    report["tune"] = {}
    seconds = {}
    for what, fn in (("(u1)", lambda: sweep_tuner(ops, cpq_ops, errs)),
                     ("(u2)", lambda: objective_parity(T, counted, routed, fa_routes, report)),
                     ("(u3)", lambda: tune_entry(T, counted, routed, fa_routes, report)),
                     ("(u4)", lambda: serve_entry(T, smi, counted, routed, fa_routes, report))):
        t1 = time.perf_counter()
        fn()
        seconds[what] = time.perf_counter() - t1
    report["tune"]["seconds"] = time.perf_counter() - t0
    report["tune"]["step_seconds"] = seconds
    log(f"[{time.perf_counter() - T0:.0f} s] phase 10 (tune and launch) took "
        f"{report['tune']['seconds']:.1f} s: "
        + ", ".join(f"{k} {s:.1f}" for k, s in seconds.items()))


# ------------------------------------------------- phase 12: the training mesh

TMESH_STEPS = 3             # (w1): AdamW and Adafactor steps over the (2, 2) mesh
TMESH_LR = 1e-4             # (w1): the optimizers' (constant) lr
TMESH_LOSS_TOL = 1e-3       # (w2): the launcher's losses, mesh vs none, relative
TMESH_LAUNCH = ("--arch", TRAIN_ARCH, "--steps", "2", "--batch", "16", "--seq", "512",
                "--log-every", "1")
TMESH_SMOKE = ("--arch", TRAIN_ARCH, "--smoke", "--steps", "2", "--batch", "16", "--seq",
               "32", "--log-every", "1")


def leaf_names(tree, pre: str = "") -> list:
    """The paths of a tree's leaves, in ``ref_leaves``' order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{pre}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{pre}[{i}]")]
    return [pre]


def leaf_step_errs(got, want, old, allow=None) -> list:
    """step_err leaf by leaf, less each leaf's ``allow`` (0 by default),
    worked on the tensors' device in float64 (a full-width tree is too
    large to move to the host for each check)."""
    out = []
    for i, (g, w, o) in enumerate(zip(got, want, old)):
        g, w, o = (t.double() for t in (g, w, o))
        d = float((g - w).abs().max()) - 2.0 ** -23 * float(w.abs().max())
        d -= allow[i] if allow else 0.0
        out.append(max(0.0, d) / max(REL_FLOOR, float((w - o).abs().max())))
    return out


def leaf_rel_errs(got, want) -> list:
    """rel_err leaf by leaf on the tensors' device in float64; a bf16 leaf
    (Adafactor's first moment) less one bf16 step of its largest |want|
    (it may round one step the other way where its inputs differ in the
    last float32 bit)."""
    out = []
    for g, w in zip(got, want):
        allow = BF16_ULP * float(w.abs().max()) if w.dtype == torch.bfloat16 else 0.0
        d = max(0.0, float((g.double() - w.double()).abs().max()) - allow)
        out.append(d / max(REL_FLOOR, float(w.double().abs().max())))
    return out


def worst(errs: list, names: list) -> tuple[float, str]:
    """The largest of per-leaf errors, and the name of its leaf."""
    i = max(range(len(errs)), key=errs.__getitem__)
    return errs[i], names[i]


def sgd_sharded(lr: float):
    """phase 9's SGD probe, also over sharded trees (train/sharded.py)."""
    from repro_torch.optim import Optimizer
    from repro_torch.params import tree_map

    def sharded(g, st, p, step):
        return tree_map(lambda gg, pp: pp.map(lambda a, b: (a.float() - lr * b).to(a.dtype),
                                              gg), g, p), st

    return Optimizer(init=lambda p: (),
                     update=lambda g, st, p, step: (tree_map(lambda x: -lr * x, g), st),
                     state_like=lambda p: (), state_specs=lambda ps, a: (),
                     update_sharded=sharded)


def mesh_step_parity(T, smi: str, report: dict) -> None:
    """(w1): full-width qwen1.5-0.5b at float32 over Mesh(data 2, model 2)
    of the one card against the unsharded step on the card, at TRAIN_SHAPE
    (2 data replicas of 2 rows), deterministic algorithms on: an SGD-probe
    step (its gradients reach the parameters as they are) against the
    unsharded step in one pass and over the mesh's own split of the rows (2
    microbatches); then TMESH_STEPS AdamW and TMESH_STEPS Adafactor steps
    against the unsharded step over that split: every loss, and after the
    last step the parameters and every state tensor, each within TRAIN_TOL,
    phase 9's (t3) measure (Adafactor's bf16 first moment within one bf16
    step more, and its parameters within lr times that a step). Then bf16:
    TMESH_STEPS AdamW steps each way (the unsharded one in one pass), the
    step times beside each other."""
    from repro_torch.configs import ShapeCfg
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.optim import adafactor, adamw
    from repro_torch.params import init_params, ref_leaves, stack_blocks
    from repro_torch.train.sharded import (gather_params, gather_tree, init_sharded,
                                           make_mesh_train_step, replica_axes,
                                           replica_devices)
    from repro_torch.train.step import TrainStepCfg, make_train_step

    out = report["train_mesh"]["w1"] = {}
    base = T.get_config(TRAIN_ARCH)
    check(base.num_blocks == 24 and base.d_model == 1024,
          f"(w1) {TRAIN_ARCH} is not at its published widths")
    mesh = make_serve_mesh(2, 2, devices=DEVICE)
    B, S = TRAIN_SHAPE
    tcfg = TrainStepCfg(microbatches=1, remat=True)
    replicas = len(replica_devices(mesh, replica_axes(base, B, mesh)))
    split = dataclasses.replace(tcfg, microbatches=replicas)
    check(replicas == 2, f"(w1) {replicas} data replicas, not 2")
    leaves = lambda t: ref_leaves(stack_blocks(t))  # noqa: E731
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        data = SyntheticLMData(cfg, ShapeCfg("train", S, B, "train"), DataConfig(seed=SEED))
        batches = [{k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(s).items()}
                   for s in range(TMESH_STEPS)]
        # the split's microbatches weigh alike, the mesh's replicas by their
        # labelled tokens: one function where every row has as many
        check(all(bool((b["labels"] >= 0).all()) for b in batches),
              "(w1) the synthetic batch has unlabelled tokens")
        params = init_params(cfg, SEED, DEVICE)
        names = leaf_names(stack_blocks(params))
        old = leaves(params)
        res = out[dtype] = {}
        # float32 with deterministic algorithms (the embedding's backward
        # otherwise sums with atomics), so that the gated numbers repeat
        torch.use_deterministic_algorithms(dtype == "float32", warn_only=True)
        if dtype == "float32":
            sgd = sgd_sharded(PARITY_LR)
            sp, _ = init_sharded(cfg, sgd, params, mesh)
            got, _, m_got = make_mesh_train_step(cfg, sgd, tcfg, mesh)(sp, (), 0, batches[0])
            got = ref_leaves(gather_tree(got, DEVICE))
            del sp
            for k in (1, replicas):
                want, _, m_want = make_train_step(cfg, sgd, dataclasses.replace(
                    tcfg, microbatches=k))(params, (), 0, batches[0])
                res[f"sgd_loss_rel_mb{k}"] = abs(float(m_got["loss"]) - float(
                    m_want["loss"])) / abs(float(m_want["loss"]))
                res[f"sgd_step_mb{k}"], res[f"sgd_worst_mb{k}"] = worst(
                    leaf_step_errs(got, leaves(want), old), names)
                del want
            del got
        opts = (("adamw", adamw(TMESH_LR, weight_decay=0.1)),
                ("adafactor", adafactor(TMESH_LR))) if dtype == "float32" else (
            ("adamw", adamw(TMESH_LR, weight_decay=0.1)),)
        for name, opt in opts:
            ref_cfg = split if dtype == "float32" else tcfg
            step = make_train_step(cfg, opt, ref_cfg)
            mesh_step = make_mesh_train_step(cfg, opt, tcfg, mesh)
            p, st = params, opt.init(params)
            sp, sst = init_sharded(cfg, opt, params, mesh)
            losses, secs = {"mesh": [], "none": []}, {"mesh": [], "none": []}
            for s in range(TMESH_STEPS):
                t = time.perf_counter()
                p, st, m = step(p, st, s, batches[s])
                torch.cuda.synchronize()
                secs["none"].append(time.perf_counter() - t)
                losses["none"].append(float(m["loss"]))
                t = time.perf_counter()
                sp, sst, m = mesh_step(sp, sst, s, batches[s])
                torch.cuda.synchronize()
                secs["mesh"].append(time.perf_counter() - t)
                losses["mesh"].append(float(m["loss"]))
            r = res[name] = {"losses": losses, "step_s": secs, "loss_rel": max(
                abs(a - b) / abs(b) for a, b in zip(losses["mesh"], losses["none"]))}
            # Adafactor: a bf16 moment one step the other way moves the update
            # by lr times that step, each step
            allow = ([TMESH_STEPS * TMESH_LR * BF16_ULP * float(x.abs().max())
                      for x in ref_leaves(st.m)] if name == "adafactor" else None)
            r["params"], r["params_worst"] = worst(
                leaf_step_errs(leaves(gather_params(sp, DEVICE)), leaves(p), old, allow), names)
            snames = leaf_names(tuple(st))
            r["state"], r["state_worst"] = worst(
                leaf_rel_errs(ref_leaves(gather_tree(sst, DEVICE)), ref_leaves(st)), snames)
            how = (f"over the same split ({replicas} microbatches)" if ref_cfg is split
                   else "in one pass")
            log(f"(w1) [{smi}] {TRAIN_ARCH} {dtype} {name} lr {TMESH_LR} over Mesh(data 2, "
                f"model 2) of one card, {B} x {S} tokens, against the unsharded step {how}: "
                f"losses mesh {', '.join(f'{x:.6f}' for x in losses['mesh'])} vs "
                f"{', '.join(f'{x:.6f}' for x in losses['none'])} (rel {r['loss_rel']:.3e}); "
                f"step s mesh {', '.join(f'{x:.3f}' for x in secs['mesh'])} vs unsharded "
                f"{', '.join(f'{x:.3f}' for x in secs['none'])}; after {TMESH_STEPS} steps "
                f"parameters {r['params']:.3e} (worst {r['params_worst']}), state "
                f"{r['state']:.3e} (worst {r['state_worst']})")
            check(all(math.isfinite(x) for x in losses["mesh"]),
                  f"(w1) {dtype} {name}: a loss is not finite")
            if dtype == "float32":
                for key in ("loss_rel", "params", "state"):
                    check(r[key] <= TRAIN_TOL,
                          f"(w1) {name} {key} {r[key]:.3e} past {TRAIN_TOL}")
            del p, st, sp, sst
        if dtype == "float32":
            log(f"(w1) float32 SGD probe, each tensor over its own largest (gate "
                f"{TRAIN_TOL}): against the unsharded step in one pass: loss "
                f"{res['sgd_loss_rel_mb1']:.3e}, change of the parameters "
                f"{res['sgd_step_mb1']:.3e} (worst {res['sgd_worst_mb1']}); over the same "
                f"split ({replicas} microbatches): loss {res[f'sgd_loss_rel_mb{replicas}']:.3e}, "
                f"parameters {res[f'sgd_step_mb{replicas}']:.3e}")
            for key in ("sgd_loss_rel_mb1", "sgd_step_mb1", f"sgd_loss_rel_mb{replicas}",
                        f"sgd_step_mb{replicas}"):
                check(res[key] <= TRAIN_TOL, f"(w1) {key} {res[key]:.3e} past {TRAIN_TOL}")
        del params, batches
        torch.use_deterministic_algorithms(False)
        torch.cuda.empty_cache()


def launcher_run(argv: list) -> dict:
    """One train launcher run in this process: its final loss, [train]
    records, seconds and peak device memory."""
    from repro_torch.launch import train

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        loss = train.main(argv)
    torch.cuda.synchronize()
    lines = buf.getvalue().splitlines()
    recs = [ast.literal_eval(ln[len("[train] "):]) for ln in lines
            if ln.startswith("[train] {")]
    return {"loss": loss, "records": recs, "lines": lines, "s": time.perf_counter() - t,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "step_s": [b["elapsed_s"] - a["elapsed_s"] for a, b in zip(recs, recs[1:])]}


def mesh_launcher_train(smi: str, report: dict) -> None:
    """(w2): the train entry point with --mesh single on the card (256
    shards at full width) against --mesh none with the same flags, and
    --mesh multi (512 shards) at --smoke against --mesh none."""
    out = report["train_mesh"]["w2"] = {}
    for what, flags, mesh in (("full", TMESH_LAUNCH, "single"),
                              ("smoke", TMESH_SMOKE, "multi")):
        runs = {m: launcher_run([*flags, "--device", f"{DEVICE}:0" if DEVICE == "cuda"
                                 else DEVICE, "--mesh", m]) for m in ("none", mesh)}
        rel = abs(runs[mesh]["loss"] - runs["none"]["loss"]) / abs(runs["none"]["loss"])
        out[what] = {m: {k: v for k, v in r.items() if k != "lines"} for m, r in runs.items()}
        out[what]["loss_rel"] = rel
        mesh_line = next(ln for ln in runs[mesh]["lines"] if ln.startswith("[train] mesh:"))
        log(f"(w2) [{smi}] launch.train {' '.join(flags)} --mesh {mesh} ({mesh_line[8:]}): "
            f"final loss {runs[mesh]['loss']:.6f} vs --mesh none {runs['none']['loss']:.6f} "
            f"(rel {rel:.3e}, gate {TMESH_LOSS_TOL}); step 2 "
            f"{runs[mesh]['step_s'][-1]:.3f} s vs {runs['none']['step_s'][-1]:.3f} s; run "
            f"{runs[mesh]['s']:.1f} s vs {runs['none']['s']:.1f} s; peak device memory "
            f"{runs[mesh]['peak_bytes'] / 1e9:.3f} GB vs {runs['none']['peak_bytes'] / 1e9:.3f}")
        check(rel <= TMESH_LOSS_TOL, f"(w2) {what} --mesh {mesh}: loss off by {rel:.3e}")


def mesh_compressed_psum(report: dict) -> None:
    """(w3): compressed_psum over 8 shards of the card against the CPU, the
    reference test's 20 error-feedback steps on (8, 128) seeded rows: the
    codes identical, and the reference's drift bound."""
    from repro_torch.distributed.collectives import shard_along
    from repro_torch.optim.compression import compressed_psum

    x = torch.from_numpy(np.random.default_rng(SEED).normal(size=(8, 128)).astype(np.float32))
    runs = {}
    for where in (DEVICE, "cpu"):
        xs = shard_along(x, 0, [torch.device(where)] * 8)
        errs = [torch.zeros_like(t) for t in xs]
        codes, means = [], []
        for _ in range(20):
            xf = torch.cat([t + e for t, e in zip(xs, errs)]).cpu()
            m, errs = compressed_psum(xs, errs)
            ne = torch.cat(errs).cpu()
            scale = max(float(xf.abs().max()) / 127.0, 1e-12)
            codes.append(torch.round((xf - ne) / scale).to(torch.int64))
            means.append(m[0][0].cpu())
        runs[where] = (codes, means)
    same = all(torch.equal(a, b) for a, b in zip(runs[DEVICE][0], runs["cpu"][0]))
    means = runs[DEVICE][1]
    true_mean = x.mean(0)
    drift = float((sum(means) / 20 - true_mean).abs().max())
    one = float((means[-1] - true_mean).abs().max())
    mean_err = max(float((a - b).abs().max()) for a, b in zip(means, runs["cpu"][1]))
    report["train_mesh"]["w3"] = {"codes_identical": same, "drift": drift, "one": one,
                                  "mean_card_vs_cpu": mean_err}
    log(f"(w3) compressed_psum over 8 shards of the card vs the CPU, 20 steps: codes "
        f"identical {same}, means within {mean_err:.3e}; drift {drift:.3e} < "
        f"{one:.3e} x 0.5 + 1e-5")
    check(same, "(w3) compressed_psum codes differ card vs CPU")
    check(drift < one * 0.5 + 1e-5, f"(w3) drift {drift} past {one} x 0.5 + 1e-5")


def mesh_state_bytes(T, report: dict) -> None:
    """(w4): full-width qwen1.5-0.5b's sharded parameters and AdamW state on
    the production mesh (16 x 16) of the card: the bytes at every grid
    position equal launch.dryrun's per-device bytes for the cell."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.optim import adamw
    from repro_torch.params import init_params
    from repro_torch.train.sharded import init_sharded, position_bytes

    cfg = T.get_config(TRAIN_ARCH)
    mesh = make_production_mesh(False, DEVICE)
    opt = adamw(TMESH_LR)
    sp, sst = init_sharded(cfg, opt, init_params(cfg, SEED, DEVICE), mesh)
    rec = dryrun.trace_cell(TRAIN_ARCH, "train_4k", False, count_flops=False)
    held = {(position_bytes(sp, pos), position_bytes(sst, pos))
            for pos in np.ndindex(*mesh.devices.shape)}
    want = (rec["param_bytes_per_device"], rec["state_bytes_per_device"])
    report["train_mesh"]["w4"] = {"positions": int(mesh.devices.size),
                                  "held": sorted(held), "dryrun": want}
    log(f"(w4) {TRAIN_ARCH} on the (16, 16) mesh: every one of {mesh.devices.size} positions "
        f"holds {sorted(held)} bytes (parameters, AdamW state); launch.dryrun's per-device "
        f"bytes {want}")
    check(held == {want}, f"(w4) position bytes {sorted(held)} vs the dry-run's {want}")
    del sp, sst
    torch.cuda.empty_cache()


def train_mesh_phase(T, smi: str, counted: list, routed: dict, fa_routes: dict,
                     report: dict) -> None:
    """Phase 12: the training mesh, (w1)-(w4); no kernel of B1-B10 may be
    launched (the reference's training reaches none)."""
    t0 = time.perf_counter()
    report["train_mesh"] = {}
    zero_launches(counted, fa_routes)
    zero_routes(routed)
    seconds = {}
    for what, fn in (("(w1)", lambda: mesh_step_parity(T, smi, report)),
                     ("(w2)", lambda: mesh_launcher_train(smi, report)),
                     ("(w3)", lambda: mesh_compressed_psum(report)),
                     ("(w4)", lambda: mesh_state_bytes(T, report))):
        t1 = time.perf_counter()
        fn()
        seconds[what] = time.perf_counter() - t1
    launched = {k: c for k, c in {
        **counted_launches(counted, fa_routes),
        **{f"{name}/{r}": n for name, (c, _) in routed.items() for r, n in c.items()}}.items()
        if c}
    report["train_mesh"].update(seconds=time.perf_counter() - t0, step_seconds=seconds,
                                launches=launched)
    check(not launched, f"(w) the training mesh launched attention kernels: {launched}")
    log(f"[{time.perf_counter() - T0:.0f} s] phase 12 (training mesh) took "
        f"{report['train_mesh']['seconds']:.1f} s: "
        + ", ".join(f"{k} {s:.1f}" for k, s in seconds.items()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the report as JSON here")
    ap.add_argument("--against", default=None,
                    help="root of another checkout of the repository (for example the "
                         "parent commit): build its kernels too and fail unless every "
                         "kernel both builds compile has the same ptxas report")
    ap.add_argument("--changed", default="",
                    help="with --against: comma-separated substrings of '<source> "
                         "<kernel>' whose ptxas reports may differ (kernels changed on "
                         "purpose); every difference is still printed")
    ap.add_argument("--mesh-depth", type=int, default=MESH_DEPTH,
                    help="layers (of 24) of phase 11's mesh serves that are cut for time "
                         "(cpq, retrieval, tiered over 2 shards, dense over 4)")
    args = ap.parse_args()
    global T0
    T0 = time.perf_counter()

    # 1) device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    import repro_torch as T
    from repro_torch.configs import RetrievalCfg
    from repro_torch.kernels import build
    from repro_torch.kernels.cpq_attn import ops as cpq_ops
    from repro_torch.kernels.decomposed_attn import ops as t1_ops
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.paged_attn import ops
    from repro_torch.kernels.topk_retrieval import ops as t3_ops
    from repro_torch.models import model as M
    from repro_torch.params import init_params, to_device
    from repro_torch.serving import scheduler as S

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
        f"count {torch.cuda.device_count()}")
    report = {"card": smi, "profile": {}}
    kmods = {"paged_decode": ops, "paged_prefill": ops,
             "paged_cpq_decode": cpq_ops, "paged_cpq_prefill": cpq_ops,
             "paged_decomposed_decode": t1_ops, "paged_decomposed_prefill": t1_ops,
             "paged_proxy_scores": t3_ops, "flash_attention": fa_ops,
             "decomposed_decode": t1_ops, "cpq_decode": cpq_ops}
    counted = [(mod, name) for name, mod in kmods.items()] + [(t3_ops, "proxy_scores")]
    # the kernels with two routes: their route counters, and the route every
    # launch of a bf16 serve takes
    routed = {"paged_decode": (ops.DECODE_ROUTE_LAUNCHES, "ring"),
              "paged_prefill": (ops.ROUTE_LAUNCHES, "tensor_core"),
              "paged_cpq_prefill": (cpq_ops.ROUTE_LAUNCHES, "tensor_core"),
              "paged_decomposed_prefill": (t1_ops.ROUTE_LAUNCHES, "tensor_core"),
              "paged_decomposed_decode": (t1_ops.DECODE_ROUTE_LAUNCHES, "tensor_core"),
              "paged_cpq_decode": (cpq_ops.DECODE_ROUTE_LAUNCHES, "single_query")}
    # ... and those of the static serves (B9)
    static_routed = {"decomposed_decode": (t1_ops.CONTIG_ROUTE_LAUNCHES, "tensor_core")}

    # 2) build: one nvcc per source, all started together (B7's two wrappers
    #    share one source, built once; B8's three routes have a source each)
    t0 = time.perf_counter()
    sources = {src: (mod, name) for mod in set(kmods.values())
               for name, src in mod.SOURCES.items()}
    build.build(sorted(sources))
    for mod, name in sources.values():
        mod.launcher(name)
    report["build_s"] = time.perf_counter() - t0
    report["nvcc_s"] = dict(build.BUILD_SECONDS)
    log(f"build: {report['build_s']:.1f} s; nvcc per source: "
        + ", ".join(f"{n} {s:.1f} s" for n, s in sorted(build.BUILD_SECONDS.items())))
    report["ptxas"] = {name: build.ptxas_report(text) for name, text in build.BUILD_LOGS.items()}
    for name, text in build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"nvcc[{name}]: {line.strip()}", file=sys.stderr)
    if args.against:  # the other tree built afresh (this one too, unless built above)
        t0 = time.perf_counter()
        cmp = build.compare(args.against, build.reports(sorted(build.KERNELS_DIR.glob(
            "*/csrc/*.cu"))))
        differ = sorted(k for k, same in cmp["compared"].items() if not same)
        named = [c for c in args.changed.split(",") if c]
        unnamed = [k for k in differ if not any(c in k for c in named)]
        report["ptxas_against"] = {"against": args.against, "compared": cmp["compared"],
                                   "changed": named, "differ": differ,
                                   "seconds": time.perf_counter() - t0}
        log(f"{build.verdict(cmp)} (against {args.against}, "
            f"{report['ptxas_against']['seconds']:.1f} s); differ, named by --changed: "
            f"{len(differ) - len(unnamed)}")
        for k in differ:
            src, name = k.split(" ", 1)
            log(f"ptxas differs: {k}: {cmp['this'][src][name]} (was {cmp['against'][src][name]})")
        check(not unnamed, f"ptxas reports differ from {args.against}: {unnamed}")

    # 3) kernels against their plain versions
    new_s = {}  # seconds of the phases added with the rest of the tick (h-j)
    errs = {name: {} for name in kmods}
    report["prefill_routes"] = {}
    # B8's bf16 cases: the kernel's, the plain version's largest distance
    # from exact attention, and the kernel's from the plain version
    report["flash_bf16_exact"] = flash_exact = {}
    for dtype in (torch.bfloat16, torch.float32):
        # qwen1.5-0.5b's shape, a GQA shape, and widths of 8-byte rows
        # (Dh 24: the tensor-core route's half-chunk loads) and of no
        # multiple of 8 (Dh 12: bf16 on the sweep)
        for KV, G, Dh in ((16, 1, 64), (8, 4, 128), (4, 2, 24), (4, 2, 12)):
            tag = f"{str(dtype).removeprefix('torch.')} KV={KV} G={G} Dh={Dh}"
            e_dec, e_pre = sweep(ops, dtype, KV, G, Dh)
            errs["paged_decode"][tag], errs["paged_prefill"][tag] = e_dec, e_pre
            for bits in (4, 8):
                e_cd, e_cp = sweep_cpq(cpq_ops, dtype, KV, G, Dh, bits)
                btag = f"{tag} bits={bits}"
                errs["paged_cpq_decode"][btag], errs["paged_cpq_prefill"][btag] = e_cd, e_cp
            routes = (ops.prefill_route(dtype, Dh, Dh),
                      cpq_ops.cpq_prefill_route(dtype, Dh, Dh, CPQ_LEVELS))
            report["prefill_routes"][tag] = dict(zip(("paged_prefill", "paged_cpq_prefill"),
                                                     routes))
            log(f"sweep {tag}: paged_decode {e_dec:.3e} "
                f"({ops.decode_route(dtype, Dh, Dh, 64)} route), paged_prefill {e_pre:.3e} "
                f"({routes[0]} route), paged_cpq_decode {e_cd:.3e}, paged_cpq_prefill "
                f"{e_cp:.3e} ({routes[1]} route; bits 8; tol {TOL[dtype]})")
        for H, Dm, kv_r, Rr in T1_SHAPES:
            tag = f"{str(dtype).removeprefix('torch.')} H={H} Dm={Dm} kv_r={kv_r} Rr={Rr}"
            e_dec, e_pre = sweep_t1(t1_ops, dtype, H, Dm, kv_r, Rr)
            errs["paged_decomposed_decode"][tag] = e_dec
            errs["paged_decomposed_prefill"][tag] = e_pre
            log(f"sweep {tag}: paged_decomposed_decode {e_dec:.3e} "
                f"({t1_ops.t1_decode_route(dtype, H, Dm, kv_r, Rr)} route), "
                f"paged_decomposed_prefill {e_pre:.3e} "
                f"({t1_ops.t1_prefill_route(dtype, Dm, Rr)} route; tol {TOL[dtype]})")
        dname = str(dtype).removeprefix("torch.")
        t0 = time.perf_counter()
        for G in (1, 2):  # B2 at the speculative verify chunk's shapes
            tag = f"{dname} verify KV={16 // G} G={G} Dh=64"
            errs["paged_prefill"][tag] = sweep_verify(ops, dtype, G)
            log(f"sweep {tag}: paged_prefill {errs['paged_prefill'][tag]:.3e} over "
                f"{5 * len(VERIFY_CHUNKS)} verify chunks (C, valid) in {VERIFY_CHUNKS} at "
                f"offsets 0, 1, 15, 17 and 1024 - C ({ops.prefill_route(dtype, 64, 64)} "
                f"route; tol {TOL[dtype]})")
        new_s["verify sweep"] = new_s.get("verify sweep", 0.0) + time.perf_counter() - t0
        for shape, err in sweep_decode_served(ops, dtype).items():
            errs["paged_decode"][f"{dname} served rows {shape}"] = err
            log(f"sweep {dname} served rows {shape}: paged_decode {err:.3e} over "
                f"{len(SERVED_DECODE)} layouts, planned and most ranks "
                f"({ops.decode_route(dtype, 64, 64, 64)} route; tol {TOL[dtype]})")
        # B3 at the served rows: qwen1.5-0.5b's T1 shape and deepseek-v2-lite's
        # MLA (the latent of 512, one roped key of 64 shared by 16 heads)
        for H, Dm, kv_r, Rr in ((16, 1024, 16, 32), (16, 512, 1, 64)):
            tag = f"{dname} served rows H={H} Dm={Dm} kv_r={kv_r} Rr={Rr}"
            errs["paged_decomposed_decode"][tag] = sweep_t1_served(t1_ops, dtype, H, Dm, kv_r,
                                                                   Rr)
            log(f"sweep {tag}: paged_decomposed_decode "
                f"{errs['paged_decomposed_decode'][tag]:.3e} over {len(T1_SERVED_DECODE)} "
                f"layouts, planned and most splits "
                f"({t1_ops.t1_decode_route(dtype, H, Dm, kv_r, Rr)} route; tol {TOL[dtype]})")
        for case, err in sweep_flash(fa_ops, dtype, MLA_FLASH_SWEEP, flash_exact).items():
            errs["flash_attention"][f"{dname} {case}"] = err
        log(f"sweep {dname} MLA prompts: flash_attention "
            + ", ".join(f"{e:.3e}" for k, e in errs["flash_attention"].items()
                        if "Dh=192" in k and k.startswith(dname))
            + f" over {len(MLA_FLASH_SWEEP)} cases (Dh 192, Dv 128; tol {TOL[dtype]})")
        for case, err in sweep_flash(fa_ops, dtype, exact=flash_exact).items():
            errs["flash_attention"][f"{dname} {case}"] = err
        for case, err in sweep_t1c(t1_ops, dtype).items():
            errs["decomposed_decode"][f"{dname} {case}"] = err
        for case, err in sweep_cpqc(cpq_ops, dtype).items():  # float32 output
            errs["cpq_decode"][f"float32 q={dname} {case}"] = err
        log(f"sweep {dname}: flash_attention {max(errs['flash_attention'].values()):.3e} over "
            f"{len(FLASH_SWEEP)} cases, decomposed_decode "
            f"{max(errs['decomposed_decode'].values()):.3e} over {len(T1C_SWEEP)}, cpq_decode "
            f"{max(errs['cpq_decode'].values()):.3e} over {2 * len(CPQC_SWEEP)} (tol "
            f"{TOL[dtype]}, cpq_decode {TOL[torch.float32]})")
        if dtype == torch.bfloat16:
            top = {k: max(e[k] for e in flash_exact.values())
                   for k in ("kernel", "plain", "kernel_vs_plain")}
            log(f"sweep bfloat16: flash_attention against exact attention (float64) over "
                f"{len(flash_exact)} cases: kernel {top['kernel']:.4e}, plain version "
                f"{top['plain']:.4e}, kernel against plain {top['kernel_vs_plain']:.4e} (the "
                f"kernel within tol {TOL[dtype]} of exact, and no farther than the plain "
                "version, in every case)")
    for name, by_tag in errs.items():
        for tag, err in by_tag.items():
            check(err <= TOL[torch.bfloat16 if tag.startswith("bfloat16") else torch.float32],
                  f"{name} {tag}: error {err}")
    errs["paged_proxy_scores"] = {}
    for KV, G, Dp in T3_SHAPES:  # float32 only: B7 takes float32 factors, int8 codes
        tag = f"float32 KV={KV} G={G} Dp={Dp}"
        errs["paged_proxy_scores"][tag] = sweep_t3(t3_ops, KV, G, Dp)
        log(f"sweep {tag}: paged_proxy_scores and proxy_scores "
            f"{errs['paged_proxy_scores'][tag]:.3e} (tol {T3_REL} x max |score|)")
    log(f"[{time.perf_counter() - T0:.0f} s] kernels checked")

    # 4a) serve full-width qwen1.5-0.5b in bf16, dense
    cfg = served_config(T)
    params = init_params(cfg, SEED, DEVICE)
    serving = T.ServingCfg(num_slots=8, page_size=16, num_pages=513, max_blocks_per_slot=64)
    reqs = make_requests(T, cfg.vocab_size)
    warm = T.ContinuousServeEngine(cfg, params, serving=T.ServingCfg(
        num_slots=2, page_size=16, num_pages=17, max_blocks_per_slot=8), device=DEVICE)
    warm.serve([T.Request(rid=0, prompt=reqs[0].prompt[:40], max_new_tokens=4)])
    del warm
    scale = cfg.head_dim ** -0.5
    L = cfg.num_layers
    launches, per_tick, per_prefill, timing, serves = {}, {}, {}, {}, {}
    unsharded = {}  # phase 4's streams and tick times, which phase 11's mesh serves meet

    def recorders_of(dec, pre):
        return {name: (kmods[name], Recorder(getattr(kmods[name], name), L, every,
                                             *split_of[name]))
                for name, every in ((dec, 10), (pre, 8))}

    kv_arenas = lambda q, k, v, *rest: (k, v)  # noqa: E731
    x_arenas = lambda qn, qr, x, kr, *rest: (x, kr)  # noqa: E731
    code_arenas = lambda q, sc, z, codes, *rest: (codes, (sc, z))  # noqa: E731
    decode_snap = lambda q, k, v, bt, ln, s: (q.clone(), bt.clone(), ln.clone())  # noqa: E731
    split_of = {  # (the call's arenas, a copy of its small inputs)
        "paged_decode": (kv_arenas, decode_snap),
        "paged_cpq_decode": (kv_arenas, decode_snap),
        "paged_prefill": (kv_arenas, lambda q, k, v, row, off, val, s:
                          (q.clone(), row.clone(), off, val)),
        "paged_cpq_prefill": (kv_arenas, lambda q, k, v, kr, vr, slot, row, off, val, s:
                              (q.clone(), kr.clone(), vr.clone(), slot, row.clone(), off,
                               val)),
        "paged_decomposed_decode": (x_arenas, lambda qn, qr, x, kr, bt, ln, wk, wv, s: (
            t1_ops.query_rows(qn, wk, x.dtype)[:, 0], qr[:, 0].to(x.dtype).contiguous(),
            bt.clone(), ln.clone())),
        "paged_decomposed_prefill": (x_arenas, lambda qn, qr, x, kr, row, off, val, wk, wv, s: (
            t1_ops.query_rows(qn, wk, x.dtype)[0], qr[0].to(x.dtype).contiguous(),
            row.clone(), off, val)),
        "paged_proxy_scores": (code_arenas, lambda q, sc, z, codes, bt, ln, n, q_scale=None: (
            q.clone(), bt.clone(), ln.clone(), n, q_scale)),
    }
    cases = {"paged_decode": decode_case(ops, scale), "paged_prefill": prefill_case(ops, scale),
             "paged_cpq_decode": cpq_decode_case(cpq_ops, scale),
             "paged_cpq_prefill": cpq_prefill_case(cpq_ops, scale),
             "paged_decomposed_decode": t1_decode_case(t1_ops, scale),
             "paged_decomposed_prefill": t1_prefill_case(t1_ops, scale),
             "paged_proxy_scores": t3_decode_case(t3_ops)}
    # T3 with top_k=256 (one of bench_retrieval.py's K): with prompts of
    # 64-512 tokens plus 64 new ones, rows past 256 keys really select
    t3_cfg = RetrievalCfg(top_k=256, recent_window=64)
    rts = {mode: T.AttentionRuntime(mode=mode) for mode in ("dense", "cpq", "decomposed")}
    rts["retrieval"] = T.AttentionRuntime(mode="retrieval", retrieval=t3_cfg)
    for mode, (dec, pre) in (("dense", ("paged_decode", "paged_prefill")),
                             ("cpq", ("paged_cpq_decode", "paged_cpq_prefill")),
                             ("decomposed", ("paged_decomposed_decode",
                                             "paged_decomposed_prefill")),
                             ("retrieval", ("paged_proxy_scores", "paged_prefill"))):
        # 4a) dense, 4b) mode="cpq", 4d) mode="decomposed", 4e) mode="retrieval"
        eng = T.ContinuousServeEngine(cfg, params, rt=rts[mode], serving=serving,
                                      device=DEVICE)
        recs = recorders_of(dec, pre)
        run = make_requests(T, cfg.vocab_size)  # a served Request keeps its tokens
        zero_routes(routed)
        results, stats, ticks, wall, counts = serve_recorded(eng, T, run, recs)
        check_finished(results, run, mode)
        check(counts[dec] == L * stats["decode_steps"] and counts[pre] == L * stats["prefill_chunks"],
              f"{mode}: launch counts {counts} vs {stats['decode_steps']} decode ticks and "
              f"{stats['prefill_chunks']} chunks")
        routes = check_routes(mode, routed, counts)
        serves[mode] = serve_metrics(stats, ticks, wall, mode)
        serves[mode]["launches"] = counts
        serves[mode]["routes"] = routes
        unsharded[mode] = {rid: r["tokens"] for rid, r in results.items()}
        unsharded[f"{mode} metrics"] = serves[mode]
        log(f"[{time.perf_counter() - T0:.0f} s] served {mode}")
        for name in (dec, pre):
            if name in timing:  # B2 again, under T3: its launches are logged only
                log(f"{name}: {counts[name]} launches in the {mode} serve, "
                    f"{counts[name] / stats['prefill_chunks']:.0f} per chunk tick")
                continue
            launches[name] = counts[name]
            per_tick[name] = counts[name] / stats["decode_steps" if name == dec
                                                 else "prefill_chunks"]
            timing[name] = time_kernel(recs[name][1], cases[name])
            log_timing(name, timing[name], launches[name], per_tick[name])
        if mode == "retrieval":
            d, r = serves["dense"], serves[mode]
            log(f"serve retrieval vs dense, same call: decode tick median "
                f"{r['decode_step_ms_median']:.3f} vs {d['decode_step_ms_median']:.3f} ms, "
                f"end to end {r['end_to_end_tokens_per_s']:.1f} vs "
                f"{d['end_to_end_tokens_per_s']:.1f} tokens/s, arena {r['arena_bytes']} vs "
                f"{d['arena_bytes']} bytes")
        del eng, recs
        torch.cuda.empty_cache()
        # chunk ticks: 10 dense, 5 cpq (its host-bound chunk tick is slow to
        # profile) and 5 decomposed
        chunk = {"dense": [(40, 50)], "cpq": [(40, 45)], "decomposed": [(40, 45)]}.get(mode, [])
        windows = chunk + [mid_decode_window(ticks)]
        report["profile"][mode] = profile_windows(
            lambda: T.ContinuousServeEngine(cfg, params, rt=rts[mode], serving=serving,
                                            device=DEVICE),
            T, make_requests(T, cfg.vocab_size), ticks, windows)
        log_profile(mode, report["profile"][mode])
        torch.cuda.empty_cache()
        log(f"[{time.perf_counter() - T0:.0f} s] profiled {mode}")

    # 4c) the tiered engine: a dense arena small enough that later requests
    #     are admitted into the CPQ tier and running dense rows escalate
    tiered = T.ServingCfg(num_slots=8, page_size=16, num_pages=97, max_blocks_per_slot=64,
                          escalated_pages=513, low_watermark=0.5, critical_watermark=0.45,
                          enable_escalation=True)
    eng = T.ContinuousServeEngine(cfg, params, serving=tiered, device=DEVICE)
    tiers, admit = [], S.Scheduler.admit_next

    def admit_counted(sched, now, step):
        req = admit(sched, now, step)
        if req is not None:
            tiers.append(req.tier)
        return req

    tiered_kernels = ("paged_decode", "paged_prefill", "paged_cpq_decode",
                      "paged_cpq_prefill")
    for name, mod in kmods.items():
        getattr(mod, name).launches = 0
    zero_routes(routed)
    S.Scheduler.admit_next = admit_counted
    run = make_requests(T, cfg.vocab_size)
    try:
        results, stats, ticks, wall = serve_timed(eng, T, run)
    finally:
        S.Scheduler.admit_next = admit
    counts = {name: kmods[name].__dict__[name].launches for name in tiered_kernels}
    routes = check_routes("tiered", routed, counts)
    check(not any(getattr(mod, name).launches for name, mod in kmods.items()
                  if name not in tiered_kernels), "tiered: a T1 or T3 kernel launched")
    check_finished(results, run, "tiered")
    serves["tiered"] = serve_metrics(stats, ticks, wall, "tiered")
    unsharded["tiered"] = {rid: r["tokens"] for rid, r in results.items()}
    unsharded["tiered metrics"] = serves["tiered"]
    serves["tiered"].update(
        escalations=stats["escalations"], cpq_admissions=int(sum(tiers)),
        admissions=len(tiers), launches=counts, routes=routes,
        dense_pages_leaked=stats["dense_pages_leaked"],
        cpq_pages_leaked=stats["cpq_pages_leaked"],
        serving={k: getattr(tiered, k) for k in ("num_pages", "escalated_pages",
                                                 "low_watermark", "critical_watermark")})
    log(f"serve tiered: {stats['escalations']} escalations, {sum(tiers)} of {len(tiers)} "
        f"admissions into the CPQ tier, pages leaked dense {stats['dense_pages_leaked']} "
        f"cpq {stats['cpq_pages_leaked']}; launches {counts}")
    check(stats["escalations"] >= 1 and sum(tiers) >= 1,
          "tiered: no escalation or no admission into the CPQ tier")
    check(stats["dense_pages_leaked"] == 0 and stats["cpq_pages_leaked"] == 0,
          "tiered: pages leaked")
    check(all(n > 0 for n in counts.values()), f"tiered: a kernel never launched: {counts}")
    check(counts["paged_decode"] == counts["paged_cpq_decode"] == L * stats["decode_steps"]
          and counts["paged_prefill"] + counts["paged_cpq_prefill"]
          == L * stats["prefill_chunks"],
          f"tiered: launch counts {counts} vs {stats['decode_steps']} decode ticks and "
          f"{stats['prefill_chunks']} chunks")
    report["serve"] = serves
    del eng
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - T0:.0f} s] served tiered")
    report["profile"]["tiered"] = profile_windows(
        lambda: T.ContinuousServeEngine(cfg, params, serving=tiered, device=DEVICE),
        T, make_requests(T, cfg.vocab_size), ticks, [mid_decode_window(ticks)])
    log_profile("tiered", report["profile"]["tiered"])
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - T0:.0f} s] profiled tiered")

    # 4f) the static ServeEngine: 8 prompts of 512 tokens, 64 new, in four
    #     modes; B8 prefills (24 launches) and decodes dense, B9, B10 and B7
    #     decode T1, T2 and T3 (24 launches per step)
    prompts = static_prompts(cfg.vocab_size)
    n_new = 64
    for mode in ("dense", "decomposed", "cpq", "retrieval"):
        eng = T.ServeEngine(cfg, params, rt=rts[mode], device=DEVICE)
        recs = {"flash_attention": (fa_ops, FlashRecorder(fa_ops.flash_attention, L))}
        if mode == "decomposed":
            recs["decomposed_decode"] = (t1_ops, t1c_recorder(t1_ops, L))
        if mode == "cpq":
            recs["cpq_decode"] = (cpq_ops, cpqc_recorder(cpq_ops, L))
        zero_routes(static_routed)
        out, stats, timer, wall, counts = serve_static(eng, T, M, prompts, n_new, recs, counted,
                                                       fa_ops.ROUTE_LAUNCHES)
        static_routes = check_routes(f"static {mode}", static_routed, counts)
        steps = stats["decode_steps"]
        check(out.shape == (8, n_new) and steps == n_new - 1
              and stats["generated_tokens"] == out.size, f"static {mode}: {out.shape}, {stats}")
        want = {name: 0 for name in counts}
        want["flash_attention"] = L * (1 + steps if mode == "dense" else 1)
        want["flash_attention/prompt"] = L         # the bf16 prefill: tensor cores
        if mode == "dense":
            want["flash_attention/decode"] = L * steps
        else:
            want[STEP_KERNEL[mode]] = L * steps
        check(counts == want, f"static {mode}: launch counts {counts}, want {want}")
        serves[f"static {mode}"] = static_metrics(out, stats, timer, wall, mode)
        serves[f"static {mode}"]["launches"] = {k: n for k, n in counts.items() if n}
        serves[f"static {mode}"]["routes"] = static_routes
        if mode == "dense":
            name = "flash_attention_prompt"
            timing[name] = time_kernel(recs["flash_attention"][1].pre,
                                       flash_prefill_case(fa_ops, scale))
            # the static serve prefills once: its count is the count per prefill
            launches[name] = per_prefill[name] = counts["flash_attention/prompt"]
            log_timing(name, timing[name], launches[name], per_prefill[name], "prefill")
        if mode != "retrieval":
            name = STEP_KERNEL[mode]
            rec = recs[name][1].dec if name == "flash_attention" else recs[name][1]
            case = {"flash_attention": flash_decode_case(fa_ops, scale),
                    "decomposed_decode": t1c_decode_case(t1_ops, scale),
                    "cpq_decode": cpqc_decode_case(cpq_ops, scale)}[name]
            n = counts[COUNT_KEY.get(name, name)]
            launches[name], per_tick[name] = n, n / steps
            timing[name] = time_kernel(rec, case)
            log_timing(name, timing[name], launches[name], per_tick[name])
        step_ms = timer.step_ms
        if mode == "dense":  # layer 0's prompt K/V, for the encoders' device check
            history = tuple(t.clone() for t in recs["flash_attention"][1].pre.arenas[0])
        del eng, recs, timer
        torch.cuda.empty_cache()
        if mode in ("dense", "decomposed"):
            report["profile"][f"static {mode}"] = [profile_static(
                lambda: T.ServeEngine(cfg, params, rt=rts[mode], device=DEVICE), T, M,
                prompts, n_new, step_ms, 30, 40)]
            log_profile(f"static {mode}", report["profile"][f"static {mode}"])
        log(f"[{time.perf_counter() - T0:.0f} s] served static {mode}")

    # 4g) one-shot admission (prefill_chunk=0), dense, on the traffic of 4a:
    #     B8 prefills each admission's padded prompt, B1 decodes
    eng = T.ContinuousServeEngine(cfg, params, serving=dataclasses.replace(
        serving, prefill_chunk=0), device=DEVICE)
    zero_launches(counted, fa_ops.ROUTE_LAUNCHES)
    zero_routes(routed)
    run = make_requests(T, cfg.vocab_size)
    results, stats, ticks, wall = serve_timed(eng, T, run)
    counts = counted_launches(counted, fa_ops.ROUTE_LAUNCHES)
    oneshot_routes = check_routes("oneshot", {"paged_decode": routed["paged_decode"]}, counts)
    check_finished(results, run, "oneshot")
    want = {name: 0 for name in counts}
    want.update({"flash_attention": L * stats["admitted"],
                 "flash_attention/prompt": L * stats["admitted"],
                 "paged_decode": L * stats["decode_steps"]})
    check(counts == want and stats["admitted"] == len(run) and not stats["chunked_prefill"],
          f"oneshot: launch counts {counts}, want {want}; {stats['admitted']} admissions")
    serves["oneshot"] = serve_metrics(stats, ticks, wall, "oneshot dense")
    serves["oneshot"]["launches"] = {k: n for k, n in counts.items() if n}
    serves["oneshot"]["routes"] = oneshot_routes
    del eng
    torch.cuda.empty_cache()
    log(f"[{time.perf_counter() - T0:.0f} s] served oneshot")

    # 4h-4j) the rest of the continuous engine's tick
    rest = serve_rest(T, dataclasses.replace(cfg, num_blocks=REST_DEPTH),
                      {**params, "blocks": [b[:REST_DEPTH] for b in params["blocks"]]},
                      serving, counted, routed, fa_ops.ROUTE_LAUNCHES, serves,
                      new_s)
    # 4r) the replica router: two replicas of the full-width model on (a)'s
    #     arena sharing one weight copy; no fault, a crash window auto-drained
    #     and re-admitted, and a rebalance of a decoding and a prefilling row
    serve_router(T, cfg, params, serving, counted, routed, fa_ops.ROUTE_LAUNCHES, serves,
                 new_s)

    # C3: the T2 (HQE) and T3 (proxy) encoders on the card and on the CPU, on
    #     layer 0's K/V of the static prompts (448 at once, 64 appended)
    report["encode_parity"] = encode_parity(*history, rts["cpq"].cpq, t3_cfg, 448)
    for what, r in report["encode_parity"].items():
        log(f"encode parity {what} (card vs CPU, no gate): {r}")
    del history

    # 5) f32 parity, kernels on and off, dense, CPQ, T1 and T3
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = to_device(_tree_float(params), DEVICE)
    # every serve's parity runs the first PARITY_DEPTH layers, to keep the
    # script (with phases 6 and 7) inside its time limit
    depth = min(PARITY_DEPTH, cfg32.num_blocks)
    cfg_p = dataclasses.replace(cfg32, num_blocks=depth)
    params_p = {**params32, "blocks": [b[:depth] for b in params32["blocks"]]}
    del params, params32
    report["parity"] = {mode: parity(T, M, cfg_p, params_p, reqs, mode)
                        for mode in ("dense", "cpq", "decomposed")}
    with TopkWitness(t3_ops, t3_cfg, cfg_p.num_layers) as witness:
        report["parity"]["retrieval"] = parity(T, M, cfg_p, params_p, reqs, "retrieval",
                                               dict(retrieval=t3_cfg))
    report["parity"]["retrieval"].update(
        topk_sets_compared=witness.sets, topk_sets_differ_plain=witness.differ_plain,
        topk_sets_differ_gather=witness.differ_gather)
    log(f"parity retrieval: of {witness.sets} (row, head, layer) top-k sets over sampled "
        f"decode calls, {witness.differ_plain} differ between B7's scores and its plain "
        f"version's, {witness.differ_gather} between B7's and the gather path's (no gate)")
    log(f"[{time.perf_counter() - T0:.0f} s] parity checked (continuous)")
    # the rest of the tick: (h), its copy-on-write probe and (i), kernels on
    # and off, the feature on and off; then the sampler, card against CPU
    parity_rest(T, cfg_p, params_p, rest, cfg.vocab_size, report, new_s)
    # (r)'s crash and rebalance runs against one fault-free engine
    router_parity(T, dataclasses.replace(cfg_p, num_blocks=ROUTER_PARITY_DEPTH),
                  {**params_p, "blocks": [b[:ROUTER_PARITY_DEPTH] for b in params_p["blocks"]]},
                  serving, report, new_s)
    report["parity"]["oneshot"] = parity(T, M, cfg_p, params_p, reqs, "dense",
                                         serving_kw=dict(prefill_chunk=0))
    for mode in ("dense", "decomposed", "cpq", "retrieval"):
        report["parity"][f"static {mode}"] = static_parity(
            T, M, cfg_p, params_p, prompts, mode, n_new,
            dict(retrieval=t3_cfg) if mode == "retrieval" else None)
    log(f"[{time.perf_counter() - T0:.0f} s] parity checked (contiguous)")
    del params_p
    torch.cuda.empty_cache()

    # 6) the DeepSeek stacks (MLA and MoE) and T1+T2
    serve_deepseek(T, M, counted, routed, static_routed, fa_ops.ROUTE_LAUNCHES, serves,
                   report, {})

    # 7) the recurrent stacks: xlstm-125m and jamba's hybrid block
    at_jamba = {}
    serve_recurrent(T, M, ops, fa_ops, counted, routed, fa_ops.ROUTE_LAUNCHES, serves, report,
                    at_jamba, {})

    # 8) the multimodal stacks: llama-vision's cross-attention, musicgen's frames
    at_multimodal = {}
    serve_multimodal(T, M, kmods, counted, t3_cfg, serves, report, at_multimodal, {})

    # 9) training: full-width qwen1.5-0.5b, the flash backward, card vs CPU
    train_phase(T, M, smi, counted, {**routed, **static_routed}, fa_ops.ROUTE_LAUNCHES, report)

    # 10) tune and launch: the tuner's kernel shapes, its objective card
    #     against CPU, the tune and serve entry points
    tune_phase(T, ops, cpq_ops, errs, smi, counted, {**routed, **static_routed},
               fa_ops.ROUTE_LAUNCHES, report)

    # 11) the serving mesh: the kernels at a shard's shapes, full-width
    #     qwen1.5-0.5b over model shards, its f32 parity, MLA, the
    #     collectives and GPipe, the launcher
    mesh_phase(T, M, ops, cpq_ops, t1_ops, t3_ops, kmods, routed, errs, unsharded, smi,
               t3_cfg, report, args.mesh_depth)

    # 12) the training mesh: full-width qwen1.5-0.5b over a mesh of the
    #     card against the unsharded step, the launcher's --mesh,
    #     compressed_psum, the dry-run's bytes
    train_mesh_phase(T, smi, counted, {**routed, **static_routed}, fa_ops.ROUTE_LAUNCHES,
                     report)

    kernel_mod = {**kmods, "flash_attention_prompt": fa_ops}
    replaces = {"paged_decode": "src/repro/kernels/flash_attn/kernel.py:223",
                "paged_prefill": "src/repro/kernels/flash_attn/kernel.py:170",
                "paged_cpq_decode": "src/repro/kernels/cpq_dequant_attn/kernel.py:281",
                "paged_cpq_prefill": "src/repro/kernels/cpq_dequant_attn/kernel.py:213",
                "paged_decomposed_decode": "src/repro/kernels/decomposed_attn/kernel.py:244",
                "paged_decomposed_prefill": "src/repro/kernels/decomposed_attn/kernel.py:187",
                "paged_proxy_scores": "src/repro/kernels/topk_retrieval/kernel.py:39",
                "flash_attention": "src/repro/kernels/flash_attn/kernel.py:276",
                "flash_attention_prompt": "src/repro/kernels/flash_attn/kernel.py:276",
                "decomposed_decode": "src/repro/kernels/decomposed_attn/kernel.py:298",
                "cpq_decode": "src/repro/kernels/cpq_dequant_attn/kernel.py:338"}
    source = {name: mod.SOURCES[name] for name, mod in kmods.items()}
    route_source = {  # the header of each served route
        "paged_decode": ops.CSRC / "paged_token.cuh",
        "paged_prefill": ops.CSRC / "paged_chunk.cuh",
        "paged_cpq_prefill": ops.CSRC / "paged_chunk.cuh",
        "paged_decomposed_prefill": t1_ops.CSRC / "paged_decomposed_chunk.cuh",
        "paged_decomposed_decode": t1_ops.CSRC / "t1_token.cuh",
        "decomposed_decode": t1_ops.CSRC / "t1_token.cuh",
        "paged_cpq_decode": fa_ops.CSRC / "single_query.cuh"}
    source.update(flash_attention=fa_ops.SOURCES["flash_decode"],
                  flash_attention_prompt=fa_ops.SOURCES["flash_prompt"])
    sdpa = "torch.nn.functional.scaled_dot_product_attention"
    library = {name: sdpa for name in kernel_mod}
    library["paged_proxy_scores"] = "torch.matmul on codes gathered beforehand, plus qz"
    library["cpq_decode"] = sdpa + " on K/V dequantized beforehand"
    served = {name: "bfloat16 KV=16 G=1 Dh=64" + (" bits=4" if "cpq" in name else "")
              for name in kmods}
    served.update({
        "paged_decomposed_decode": "bfloat16 H=16 Dm=1024 kv_r=16 Rr=32",
        "paged_decomposed_prefill": "bfloat16 H=16 Dm=1024 kv_r=16 Rr=32",
        "paged_proxy_scores": "float32 KV=16 G=1 Dp=64",
        "flash_attention": "bfloat16 B=8 T=1 S=575 H=16 KV=16 D=64 causal=False",
        "flash_attention_prompt": "bfloat16 B=8 T=512 S=512 H=16 KV=16 D=64 causal=True",
        "decomposed_decode": "bfloat16 B=8 N=576 H=16 Dm=1024 kv_r=16 Rr=32 length=575",
        "cpq_decode": "float32 q=bfloat16 B=8 N=576 KV=16 G=1 Dh=64 bits=4 length=575 "
                      "round=True"})
    # B8's sweep, split by route: a decode token, or a prompt
    errs["flash_attention_prompt"] = {k: e for k, e in errs["flash_attention"].items()
                                      if " T=1 " not in k}
    errs["flash_attention"] = {k: e for k, e in errs["flash_attention"].items()
                               if " T=1 " in k}
    root = os.path.dirname(os.path.abspath(__file__))
    kernels = []
    for name in kernel_mod:
        t, key = timing[name], COUNT_KEY.get(name, name)
        by_serve = {mode: sv["launches"][key] for mode, sv in serves.items()
                    if sv.get("launches", {}).get(key)}
        if name == "paged_proxy_scores":  # B7's contiguous wrapper, the static T3 decodes
            for mode in ("static retrieval", "static musicgen-large retrieval"):
                by_serve[mode] = serves[mode]["launches"]["proxy_scores"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": os.path.relpath(str(source[name]), root),
            "replaces": replaces[name], "launches": launches[name],
            # per decode or chunk tick; B8's prompt route per static prefill
            **({"launches_per_prefill": per_prefill[name]} if name in per_prefill
               else {"launches_per_tick": per_tick[name]}),
            "max_abs_err": errs[name][served[name]], "max_abs_err_sweep": errs[name],
            "ms": t["ms"], "eager_ms": t["eager_ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "library": library[name], "timed_samples": t["samples"],
            "launches_by_serve": by_serve})
        tune = report["tune"]  # phase 10's runs: the objective's genomes, tune, serve
        runs = {**{f"objective {w}": r for w, r in tune["objective"].items()},
                "tune --smoke": tune["entry"], **{f"serve {w}": r for w, r in tune["serve"].items()}}
        kernels[-1]["launches_in_phase_10"] = {w: r["launches"][key] for w, r in runs.items()
                                               if r["launches"].get(key)}
        mesh = report["mesh"]  # phase 11: the serves over model shards, a launch a shard
        in_11 = {w: r["launches"][key] for w, r in mesh["serves"].items()
                 if isinstance(r, dict) and r.get("launches", {}).get(key)}
        in_11.update({f"deepseek-v2-lite {d}": r["launches"][key]
                      for d, r in mesh["mla"].items() if r["launches"].get(key)})
        if in_11:
            kernels[-1]["launches_in_phase_11"] = in_11
        if name in at_jamba:  # B1 and B8 at jamba's attention: 64 heads over 8, Dh 128
            kernels[-1]["at_jamba"] = {
                "max_abs_err": errs[name][JAMBA_SWEPT[name]], "swept": JAMBA_SWEPT[name],
                **{k: at_jamba[name][k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                                  "bound_by", "library_ms", "samples")}}
        if name in at_multimodal:  # the shapes of phase 8's serves (p) and (q)
            swept = {shape: MULTIMODAL_SWEPT[name, shape] for shape in at_multimodal[name]}
            kernels[-1]["at_multimodal"] = {
                shape: {"max_abs_err": errs[name][swept[shape]], "swept": swept[shape],
                        **{k: t[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms",
                                             "bound_by", "library_ms", "samples")}}
                for shape, t in at_multimodal[name].items()}
        if name in routed or name in static_routed:
            # B2, B3, B4, B6, B9: the tensor-core kernel; B5: the single-query
            # one; B1: the ring
            route = {**routed, **static_routed}[name][1]
            kernels[-1].update({
                f"{route}_source": os.path.relpath(str(route_source[name]), root),
                "routes_by_serve": {mode: sv["routes"][name] for mode, sv in serves.items()
                                    if sv.get("routes", {}).get(name, {}).get(route)}})
    report["kernels"] = kernels
    report["run_s"] = time.perf_counter() - T0
    report["log"] = LOG
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in e.items() if k != "max_abs_err_sweep"}
                                  for e in kernels]}))  # the sweep's errors: --out
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def _tree_float(tree):
    if isinstance(tree, dict):
        return {k: _tree_float(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_float(v) for v in tree]
    return tree.float()


if __name__ == "__main__":
    sys.exit(main())
