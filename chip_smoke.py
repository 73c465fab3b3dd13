#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (navillm_tpu_torch) once on one H100.

    python3 chip_smoke.py            # from the repository root

Phases, in order; any failure raises and the script exits nonzero:
  0. device: a CUDA card of compute capability 9.0; prints nvidia-smi's
     name and power limit;
  1. build: compiles every kernel (csrc/flash_attn_fwd.cu,
     flash_attn_bwd.cu, flash_attn_bwd_dq.cu, matmul_q4.cu) with nvcc for
     sm_90a, all at once, and prints ptxas's registers and spills for each;
  2. kernel vs plain: the flash-attention forward kernel (K1) against its
     plain PyTorch version (32 heads of 128, bf16, left-padded masks with
     fully-masked rows): causal at B=4 with T in {65, 128, 640, 1000,
     1024}, B=16 at T=1024 (the training shape), one GQA case, one D=64
     case, one non-causal case with S != T and one with flat rows (q / 8);
     O is held per element to a bound scaled by the element and its row's
     RMS (testing.attn_excess), which the plain version with one key, or
     one 64-key tile, hidden must fail on the rows that see 256 keys or
     more; then K1, its plain version and one library call
     (F.scaled_dot_product_attention with the same boolean mask, a
     yardstick the port never calls; its own max |d| from the plain
     version printed beside it) timed with CUDA events at the eval and
     training shapes, on full masks and on PR 1-3's left-padded masks;
  3. the eval slice: greedy R2R streaming evaluation (validate_streaming)
     of the navigation model at Vicuna-7B width, LLM_LAYERS (16) of its 32
     layers (bf16, random weights from a seed) on a synthetic 8x8 grid
     world; every LLM layer of every step must go through the kernel;
  4. model-level A/B: one forward_navigation step through the kernel and
     through the eager attention path on the same inputs;
  5. backward kernels vs plain: the dQ kernel (K3), which also writes
     delta = rowsum(O * dO), and then the dK/dV kernel (K2) on that delta,
     against their plain versions (on the same delta; delta itself against
     attention_delta to DELTA_RTOL of each row's sum of |O * dO|) on
     BWD_CASES: a GQA case, a D=64 case and a non-causal case with S != T
     at B=4, then the training slice's shapes (B = rows per grad call, 32
     heads of 128, bf16, causal, T in {640, 1024}, and T=1024 with flat
     rows), all on left-padded masks with fully-masked rows, whose dQ must
     be exactly 0 (and hidden keys' dK and dV), under phase 2's
     per-element bound, which a hidden key or key tile (dQ) and a skipped
     query row or 64-row query tile (dK/dV) must fail; the differentiable
     FlashAttention against autograd through the eager path; then both
     kernels (on full masks and on PR 2's left-padded ones, each with
     nvidia-smi's SM clock and power read while they run), their plain
     versions and the backward of the masked F.scaled_dot_product_attention
     call (the library yardstick for K2 + K3, its max |d| from the plain
     versions beside it) timed with CUDA events;
  6. the training slice: R2R teacher-forcing training of the same 7B-width
     model through train_one_epoch (stage pretrain, fused teacher, dropout
     on, AdamW, gradient accumulation 2): a warm-up epoch, then 4 batches
     of 8 episodes (2 optimizer steps); every LLM layer of every grad call
     must go through the three kernels;
  7. gradient A/B: one grad call through the kernels and through the eager
     attention path, on the same inputs and weights with dropout off;
  8. int4 matmul vs plain: the int4 dequant-matmul kernel (K4) against its
     plain version at the 7B layer shapes (h, o) in {(4096, 4096), (4096,
     11008), (11008, 4096)}, m in {4096, 3584, 7}, w4 (bf16 x), w4a8
     (int8 x) and f32 x (split in the launch into bf16 high and low parts;
     held to 1e-4 of max |ref|, the JAX test's bound), timed with CUDA
     events beside a dense bf16 torch.matmul and, for w4,
     torch._weight_int4pack_mm on the same weight repacked (the library
     yardstick, its max |d| from the plain version beside it);
  9. the w4 slice: the trained model's LLM quantized to int4 on the card
     (quantize_nav_params, bits=4), then phase 3's evaluation again; every
     layer matmul of every step must go through the int4 kernel;
 10. the w4a8 slice: phase 9 with act_int8 (int8 activations);
 11. int4 model-level A/B: one forward_navigation step on the int4 tree
     through the kernel and through its plain version, w4 and w4a8.
Phase 2 also checks K1 on the prefill's right-padded masks (B=8, T in
{192, 1024}, the last row all false, whose O must be finite) and times it
at B=8, T=192. The subword slices run between phases 4 and 5 (bf16) and
after phase 10 (int4):
 12. the BPE check: the port's NavTokenizer.bpe (plain Python) gives the
     golden ids of tests/fixtures/bpe_nav_golden.json (made by the JAX
     package's tokenizer; a CPU test keeps it equal), decode(encode(x)) ==
     x, and the mean prompt width of phase 3's prompts, byte against BPE;
 13. phase 3 on BPE prompts (NavTokenizer.bpe(max_length=1024,
     pad_to_multiple=64), RolloutDims(48, 44, 12, 16, max_prefix=192)),
     uncached: one K1 launch per layer of every step;
 14. the same run with args.prefix_cache: it must take the cached step
     only (prefills and eval_step_cached, no whole-prompt step); K1
     launches once per layer of every prefill call and never in a cached
     step (the window's attention is the eager path); printed beside
     phase 13: tokens and wall ms per step, episodes/s, the window widths,
     cache bytes, peak memory and the trajectories both share;
 15. cached-step A/B: one snapshotted step with history through
     eval_step_cached and through eval_step on the same state and prompts,
     candidate logits gated per element (CACHED_LOGIT_*); the step with
     the last cached token hidden must fail the gate. Then one DAgger batch
     sampled through uncached and through cached sampling on the same
     noise per (slot group, step) (sampling_probe): per step the candidate
     logits within that gate and the same draw wherever the Gumbel-max
     margin exceeds what the gate can move (sampled_ab), which the cached
     run with the last cached token of every row hidden must fail;
 16. phase 14 on the int4 tree (w4): K4 launches 7 times per layer of
     every prefill call and cached step;
 17. phase 16 with act_int8 (w4a8): every K4 launch in int8 mode.
The DAgger half and the training driver run after phase 7, while the bf16
model is live; phases 18-20 on it, on BPE prompts and RolloutDims(48, 44,
47, 16, max_prefix=192):
 18. train_one_epoch at stage multi with the JAX defaults (fused_dagger,
     dagger_streams=2, dagger_prefix_cache=True): a warm-up epoch, then 4
     batches of 8 (2 teacher, 2 DAgger, 2 optimizer steps); every DAgger
     batch samples through the prefix-cached step (no uncached step, no
     mid-batch bailout), every draw is a valid candidate of its row, K1 =
     32 x (prefill calls + uncached steps) + 64 x grad calls and K2 = K3 =
     32 x grad calls; prints ms per teacher and per DAgger batch (sampling
     and loss pass apart), LLM tokens per sampling step, cache bytes and
     peak memory;
 19. the sampler on the card (Gumbel-max: frequencies within 5 sigma of
     softmax(logits/T) at T in (1, 0.5), no masked candidate, T -> 0 gives
     the argmax, the override wins, a seed repeats), then one DAgger batch
     sampled and replayed with its actions forced through cached and
     uncached sampling: the same trajectories, losses within
     DAGGER_AB_LOSS_REL and gradients within phase 7's cosine;
 20. run_training at stage multi (injected runner) from a YAML text the
     port's own reader parses: 1 epoch of 4 batches, streaming validation
     of 16 episodes, max_saved_checkpoints=1, so epoch_0 is written in the
     torch backend (bf16 kept), then restored into a freshly drawn model and
     compared bit for bit; prints its bytes, write and read seconds and the
     free disk;
 21. the entry point's main() (python -m navillm_tpu_torch.train) on its
     defaults, the card and stage multi, with build_runner's model (2
     layers, 4 heads of 64, bf16): 1 epoch of 4 batches of 4, validation,
     an npz checkpoint; its kernel launches as the path implies (K1 once
     per layer of every grad call: this model does not remat).
Generation at 7B width on BPE prompts, phases 22-24 on the bf16 model
after phase 21, phase 25 on the int4 tree after phase 11:
 22. generate A/B: four EQA prompts with their panorama and history
     injections, left-padded to the 64 bucket; the prefill through K1
     against the eager attention (every prefill row finite, the last
     position's logits per element within the CACHED_LOGIT_* bound), the
     greedy tokens of both equal on every step whose top-2 margin exceeds
     that bound (the first parting step reported), decode_step's hidden at
     step 0 against forward_hidden over prompt + token within the same
     bound; ms per prefill, per decode token, device events per decode
     step (torch.profiler);
 23. EQA streaming evaluation (validate_streaming("EQA"): trie-constrained
     answers from the generation queue, the oracle pass in the same slot)
     of 16 episodes in 2 slot groups of 4, uncached and prefix-cached:
     every answer in the vocabulary, K1 = 32 x (generate calls + uncached
     steps + prefill calls); ms per nav step and per generate call,
     episodes/s, peak memory;
 24. run_training at stage multi with --enable_summarize --enable_fgr2r and
     --test_datasets R2R EQA: 4 batches of 8 (the teacher batches run the
     FGR2R and summarization heads), validation of 8 episodes of each
     task; losses finite and below MAX_LOSS, K2 = K3 = 32 x grad calls
     (the heads' included), one head call's gradient through the kernels
     against eager attention within MIN_GRAD_COSINE; per teacher batch the
     navigation and head ms, head calls, trained tokens/s, peak memory;
 25. phase 23 uncached on the int4 tree (K4 = 7 per layer of every LLM pass,
     decode steps included), K4 against its plain version at the decode shape
     m = 4, and one decode step's logits through K4 against q4_impl="plain"
     within the CACHED_LOGIT_* bound; ms per decode token beside phase 23's.
Object grounding at 7B width on BPE prompts, phases 26-28 on the bf16 model
after phase 24 (the model carries the panorama's object branch, obj_feat_size
768; objects from synthetic_object_db, OG_OBJECTS per viewpoint under
max_objects 70, configs/multi.yaml's):
 26. OG A/B: forward_object_grounding on eight REVERIE OG prompts (24
     objects and 0-12 history embeds each, one row with no object) through
     K1 and through the eager attention: obj_logits within the
     CACHED_LOGIT_* bound on the valid options, every other option exactly
     NEG_INF, the same pick wherever the top-2 margin exceeds what the
     bound can move; ms per OG forward;
 27. REVERIE and SOON streaming evaluation (validate_streaming with
     enable_og, the scripts/evaluation recipe: --do_sample --temperature
     0.01) of 16 episodes each in 2 slot groups of 4, uncached and
     prefix-cached, then argmax: every pred_objid one of its final
     viewpoint's objects (None exactly where there is none), SOON's
     direction finite, the metrics finite, K1 = 32 x (uncached steps +
     prefills + OG calls), every draw that leaves the argmax of its logits
     on a top-2 margin within 20 temperatures; ms per nav step and per OG
     call, episodes/s, peak memory, sampled trajectories equal to argmax;
 28. run_training at stage multi over R2R, REVERIE and SOON with
     --enable_og --enable_summarize --enable_fgr2r: 4 batches of 8 (the OG
     head on every REVERIE/SOON batch, teacher or DAgger), validation of 8
     episodes of each task; losses finite and below MAX_LOSS, K2 = K3 = 32
     x grad calls (the heads' included), calc_overall_score finite, one OG
     head call's gradient through the kernels against eager attention
     within MIN_GRAD_COSINE; per batch the navigation and head ms, OG calls,
     trained tokens/s, peak memory. Then the same flags on the command
     line: python -m navillm_tpu_torch.train's main() on its own small bf16
     model with --fuse_obj and --do_sample --temperature 0.01 (validation
     sampled).
The rest of the paper's task mix at 7B width on BPE prompts, phases 29-32
on the bf16 model after phase 28 (configs/multi.yaml's CVDN, ScanQA and
LLaVA sections and its stage sources; image_feat_size 1024, obj_feat_size
768):
 29. CVDN streaming evaluation (scripts/evaluation/eval_cvdn.sh: greedy,
     val_max_action_len 30) of 16 dialogs of 60-128 words in 2 slot groups
     of 4, under the runner's default dims (160 graph nodes, 32 history
     slots), the stop logit lowered by AB_STOP_SHIFT so that the dialogs
     walk to the 30-step cap, uncached, then prefix-cached with every cached
     step replayed through eval_step on the same state and gated per
     element (CACHED_LOGIT_*; the step with each row's last history entry
     hidden from its cache must move the logits FAULT_RESOLVE times as far
     as the cached step does), then prefix-cached and timed: trajectories start at their start
     panorama, the scores finite, K1 = 32 x (uncached steps + prefills);
     ms per step, episodes/s, LLM tokens per step, the longest prompt and
     peak memory;
 30. ScanQA evaluation (ScanQAAgent.validate, scripts/evaluation/
     eval_scanqa.sh's generation: 36 frames per question, 20 tokens, no
     trie) of 16 questions in batches of 4: one batch's prefill through K1
     against the eager attention (first-token logits within the
     CACHED_LOGIT_* bound, every row finite), K1 = one per layer of every
     generate call, every answer a string, the scores finite; ms per generate
     call and per decode token, device events per decode step, BLEU-4, CIDEr,
     exact match;
 31. run_training at stage multi over configs/multi.yaml's six sources at
     its ratios with --enable_og --enable_summarize --enable_fgr2r: 4
     batches of 8 (at MIX_SEED a CVDN teacher batch, a CVDN DAgger batch at
     train_max_action_len 15, a LLaVA batch and a ScanQA batch), validation
     of 8 CVDN dialogs and 8 ScanQA questions; losses finite and below
     MAX_LOSS, gradient norms finite and > 0, K2 = K3 = 32 x grad calls,
     the first ScanQA batch's gradient through the kernels against eager
     attention within MIN_GRAD_COSINE; ms per batch by type, trained
     tokens/s, peak memory;
 32. python -m navillm_tpu_torch.train's main() on its small card model at
     stage pretrain (configs/multi.yaml's Pretrain sources, the augmented
     sets from .json files) and at stage multi (its Multi sources), each
     with the three heads and --test_datasets CVDN ScanQA; then stage
     pretrain with the augmented sets' .jsonl files (bert-base-uncased
     ids), read through the default decoder over an offline Hugging Face
     cache under a temporary $HF_HOME and then with testing.aug_decoder
     injected: the decoded instructions equal, the batches, losses and
     gradient norms equal bit for bit, K1-K3 as the path implies; not a
     speed cell.
The pretrained path at 7B width, phase 33 on the bf16 model after phase 32,
phases 34 and 35 after phase 25 (the bf16 model freed):
 33. the model's LLM written as an HF-layout checkpoint with plain code
     (models/convert.save_vicuna: config.json with bpe_nav.json's base
     vocabulary of 1016, ~5 GB safetensors shards and their index, and
     bpe_nav.json as tokenizer.json), then read back through build_runner
     with the CLI's --pretrained_model_name_or_path on the card: every leaf
     equal to its source bit for bit (rows 1016..1023 of embed and lm_head
     the numpy-f32 mean of the checkpoint's rows), one forward_navigation
     step on phase 4's inputs through K1 giving the source's logits bit
     for bit; write and load seconds, the host RSS during the load and the
     device peak. Then the same checkpoint with LLaMA's sentencepiece
     tokenizer.model in place of tokenizer.json (tests/fixtures/spm_llama,
     1016 pieces, read by models/sentencepiece.py) through build_runner,
     and 8 R2R episodes of streaming evaluation from it against the same
     model with the tokenizer.json transformers converted from that model:
     every prompt's ids, the trajectories and every step's logits equal bit
     for bit, K1 once per layer of every uncached step; both routes' load
     seconds and encode ms per prompt, and a seeded 32000-piece model's
     (Vicuna's size) on the host;
 34. main() from that directory at stage multi, bf16, --adam_8bit: 4
     batches of 8 over phase 32's R2R world (gradient accumulation 2: 2
     optimizer steps), validation of 4 episodes, epoch_0 (torch backend);
     K1-K3 per grad call, the 8-bit moments against exact AdamW on one
     trained layer slice (tests/test_optim8.py's closeness bound on a
     regression), moment bytes against AdamW's, the peak against phase
     31's, losses and optimizer-step ms; then eval_r2r.sh's shape, --mode
     test --resume_from_checkpoint epoch_0 from the same directory: the
     resumed tree equal to the trained one bit for bit, K1 once per layer
     of every step;
 35. --mode test --quantize_llm --quant_bits 4 from that directory
     (quantize_host_llama on the card): K4 = 7 per layer of every LLM pass, the
     int4 tree equal to phase 9's byte for byte on the checkpoint's vocabulary,
     and phase 9's evaluation replayed on it (phase 9's tokenizer,
     panorama and heads) giving phase 9's trajectories.
The per-step paths, bf16 at 7B width, after phase 32 (each prints the
agent's per-stage host timer, agent.timer.report()):
 36. train_one_epoch at stage multi through the per-step rollouts
     (--no-fused_teacher --no-fused_dagger --dagger_streams 1): a warm-up
     epoch, then 4 batches of 8 (AdamW, 2 optimizer steps); K1 64 and K2,
     K3 once per layer of every grad call; then one teacher batch, dropout off,
     per-step against the fused teacher (trajectories, loss within
     DAGGER_AB_LOSS_REL, whole-gradient cosine >= 0.999);
 37. the per-step DAgger half with --dagger_pipeline, 2 streams
     interleaved against the same streams drained in sequence (dropout
     off; whole-gradient cosine >= 0.999), both wall times and the
     timer's nav_dispatch / nav_sync;
 38. run_training --mode test --no-streaming_eval: batched validation of
     32 R2R and 16 EQA episodes (trie, oracle pass), K1 once per layer of every
     navigation forward and generate call, the trajectories against
     validate_streaming's under the near-tie rule (where they part, the
     reference's top-2 margin within logit_tol's bound);
 39. a runner with device_memory=False against the device-memory runner:
     one fused teacher batch, one fused DAgger batch (the device runner's
     own draws forced), streaming eval of 8 episodes; losses within
     DAGGER_AB_LOSS_REL, cosine >= 0.999, trajectories under the near-tie
     rule;
 40. training on EQA batches: the fused teacher, the per-step teacher and
     the fused DAgger, each running the answer head's grad call.
The rest of quantization, at 7B width on BPE prompts:
 43. (after phase 19, bf16 model) phase 18 with --dagger_sample_quant:
     every sampling step and prefill on the runner's W8A8 policy (the LLM
     quantized to int8, int8 activations), made once per optimizer step
     (gate: quantizations = optimizer steps); sampling ms per DAgger batch
     beside phase 18's, ms per quantization, peak; then one DAgger batch
     with dropout off sampled on the W8A8 policy and forced through the
     live and the W8A8 policy: the same trajectories, losses within
     SAMPLE_Q_LOSS_REL, gradient cosine >= 0.999;
 42. (after phase 25, int4 tree) phase 23 with act_int8 (w4a8, whose
     lm_head product is W8A8 on int8 weights), with a bf16 and then an int8
     prompt K/V: answers in the vocabulary, K4 224 per LLM pass with int8
     x; the first decoded token's logits and one decode step on the int8
     prompt K/V through K4 against its plain version (logit_tol);
 44. REVERIE and SOON (INT4_OG_EPISODES each, T = 0.01, the OG queue) and
     CVDN (INT4_CVDN_EPISODES dialogs, prefix cache with the int8 K/V,
     every cached step replayed through eval_step, then timed) on the int4
     tree, with phases 27's and 29's gates and K4 224 per LLM pass;
 41. int8 weights, at all 32 of Vicuna-7B's layers: the model drawn
     quantized on the card (init_nav_params(quantize_llm=True)) equal bit
     for bit to quantizing the bf16 init, each path's peak memory; then R2R
     streaming evaluation
     of W8A8_EPISODES: weight-only int8 with a bf16 prefix cache (reference),
     W8A8 uncached, W8A8 with the prefix cache and the int8 K/V, all with
     the candidates in graph order (where a kv8 trajectory parts from the
     reference's, the top-2 margin within twice what the int8 noise moves
     a logit on the episodes' first steps, plus the bf16 limit; the int8
     product exact against f64 at the model's shapes);
     ms per step, padded int8 products per step,
     cache bytes per slot group (bf16 against int8), LLM bytes, peak; one
     kv8 cached step against the uncached W8A8 step (phase 15's A/B), and
     one kv8 cached step against the uncached step on bf16 activations,
     whose planted faults add the last cached token's K scaled to zero.
Slice 14, after phase 44 (the int4 and int8 trees freed):
 45. the feature-extraction towers, EVA02-CLIP-L-14-336 and CLIP
     ViT-L/14-336, at full width (24 layers, width 1024, 577 tokens),
     random f32 weights (no TF32), through FeatureExtractor's batched
     forward over VIT_VIEWPOINTS x 36 synthetic preprocessed views:
     images/s beside the FP32 bound (0.382 TFLOP per image at 67
     TFLOP/s), peak memory; 2 images against the same forward in f64 and
     2 images alone against their batch of 36, each within VIT_REL of the
     largest feature;
 46. tp=2 evaluation at the full 7B: one card's R2R streaming runs of
     TP_EPISODES episodes in graph order on BPE prompts (bf16 and int4,
     uncached and prefix-cached), then two spawned ranks (gloo over
     localhost, CUDA tensors staged through host memory; NCCL refuses two
     ranks on one card) that draw the same weights, keep their shards
     (16 of 32 heads, K1 on them; K4 on the int4 shards) and run the same
     four evaluations under phase_slice's gates; the ranks' trajectories
     equal each other's, one step's logits within logit_tol of one
     card's, trajectories beside one card's; K4 at the shards' shapes
     (Q4_TP_SHAPES) against its plain version; ms per step and per-rank
     peak memory;
 47. dp=2 x tp=2 training in four spawned ranks at full width and
     DP_TP_LAYERS layers (the full depth would not fit four times):
     stage pretrain, fused teacher, no dropout, graph order, ZeRO-1
     AdamW, two optimizer steps of 8 episodes (4 per data-group rank);
     K1-K3 launches as phase 6 counts them, parameters equal across the
     data group, the data group's mean loss within DP_TP_LOSS_REL of one
     card's on the concatenated batches, moment bytes per rank against
     replicated, and an all_gather_objects merge over the four ranks.
A rank that fails fails the run. The kernels line's launches_by_phase
gains 46 (rank 0's runs) and 47, and K4's row its shards' shapes.
After phase 40 (bf16 model live):
 48. the feature prefetcher (data/prefetch.py, the agent's
     FeaturePrefetcher) on the fused trainers: 2 teacher and 2 DAgger
     batches of 8 through agent.train at stage multi (remat, BPE, cached
     sampling, no optimizer step) over a disk-backed store of one .npy
     file per viewpoint at 1024 wide (testing.NpyFeaturesDB, with
     ImageFeaturesDB's reads), run with the prefetcher and held off
     (testing.hold_off_prefetch); the losses equal
     bit for bit in every run, gradients finite, K1-K3 launches as phase
     18 counts them; ms per batch, pano_assemble and get_obs ms per call
     both ways, keys prefetched and the hit share of get_obs reads, beside
     nvidia-smi's name and power limit. Then phase 13's streaming
     evaluation over the same .npy store and over the synthetic store
     (whose reads the pool throws away), each with and without the
     prefetcher: the same trajectories in every run, ms per step both
     ways. launches_by_phase gains 48 and 48_eval.
After phase 48 (bf16 model live):
 50. the HDF5 feature files, read and written by the port's own reader
     and writer (utils/hdf5.py; no h5py module may load): (a) the
     committed h5py-made fixture (tests/fixtures/hdf5/) read bit for bit
     against its .npz twins; (b) the eval world's viewpoints written by
     testing.write_hdf5_features (SyntheticImageFeaturesDB's values,
     [36, 1024] f32, the extractors' gzip chunks), then phase 13's
     streaming evaluation (BPE, the prefetcher on) over
     create_feature_db's ImageFeaturesDB on that file and over the
     synthetic store: trajectories and every step's logits equal bit for
     bit, K1 once per layer of every step; the host's open and index ms (and
     for an index of 10,567 keys), ms per [36, 1024] read, write MB/s, get_obs
     and pano_assemble ms and ms per step both ways, beside nvidia-smi's
     name and power limit; (c) phase 21's entry point with its
     feature_database written as an HDF5 file and create_feature_db left
     as it is: the file opened once, losses, gradient norms, metrics and
     K1-K3 launches equal to phase 21's; (d) the EVA02 tower encodes 2
     viewpoints x 36 views, written by the extractors' writer and read
     back bit for bit, then extract_features_mp3d over 2 x 36 PNG
     renders, its file within VIT_REL of encode_images.
     launches_by_phase gains 50 and 50_cli.
After phase 47 (nothing else on the card):
 49. a Meta-Llama-3-8B-shaped directory through read_args -> build_runner
     (--pretrained_model_name_or_path DIR --from_scratch --precision
     bf16): Meta-Llama-3-8B's config.json (32 heads over 8 KV heads, MLP
     14336, vocabulary 128256, rope_theta 500000) and a LLaMA-3-layout
     tokenizer.json (the Split regex, ByteLevel without one,
     ignore_merges) grown by testing.llama3_tokenizer_spec from the
     committed fixture to 128000 BPE entries and 256 special tokens,
     random bf16 weights from the seed; at phase 13's dims, 16 R2R
     episodes uncached (K1 32 per step), the same prefix-cached (phase
     14's gates) and phase 15's A/B (C-w1), 8 episodes on the tree
     quantized to int4 on the card (K4 224 per LLM pass); every prompt of
     the first run encodes to the ids of a fresh load; K1 at 32/8 heads
     at the step's and the prefill's widest shapes and K4 at (m, 4096,
     1024), (m, 4096, 14336) and (m, 14336, 4096) for the int4 step's m
     and m = 4, against their plain versions, timed beside their bounds
     and library calls (masked SDPA with enable_gqa;
     torch._weight_int4pack_mm). launches_by_phase gains 49, 49_cached
     and 49_w4, K1's row gqa_32_8 and K4's llama3_8b.
The cached-vs-uncached comparisons (15, 19, 29, 41, 44, 49) gate the candidate
logits by cached_logit_tol, tied to the spread of the row's valid logits
(C-w1), and print each planted fault's margin.
The kernels line lists K1-K4 with each one's time, its plain version's,
the library call's (or why there is none) with its agreement, the worst
gate excess of the checks (K3: and of its delta) and its bound: the
larger of
the bytes it must move over 3.35 TB/s and its FLOPs over 989 TFLOP/s (the
H100 SXM's bf16 dense peak). Then nvidia-smi's name and power limit, and
the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import random
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from navillm_tpu_torch import testing as T
from navillm_tpu_torch import train as TRAIN
from navillm_tpu_torch.agents import device_memory as DM
from navillm_tpu_torch.agents import fused_teacher as FT
from navillm_tpu_torch.agents.mp3d_agent import R2RAgent, TrainArgs
from navillm_tpu_torch.agents.runner import NavModelRunner, RolloutDims
from navillm_tpu_torch.convert import flatten_tree, init_nav_params
from navillm_tpu_torch.data import aug as AUG
from navillm_tpu_torch.data.feature_db import (NUM_VIEWS, ImageFeaturesDB,
                                               SyntheticImageFeaturesDB,
                                               create_feature_db,
                                               synthetic_object_db)
from navillm_tpu_torch.data.loaders import Dataloader, MetaLoader
from navillm_tpu_torch.data.r2r import R2RDataset
from navillm_tpu_torch.models import decoding as D
from navillm_tpu_torch.models import llama as L
from navillm_tpu_torch.models.convert import save_vicuna
from navillm_tpu_torch.models.llama import LlamaConfig, _act_q
from navillm_tpu_torch.models.nav_model import (NavModel, NavModelConfig,
                                                forward_navigation,
                                                forward_object_grounding)
from navillm_tpu_torch.models.pano_encoder import PanoConfig
from navillm_tpu_torch.models.quant import (_quant_one4, is_quantized,
                                            quantize_nav_params, weight_bits)
from navillm_tpu_torch.models.tokenization import NavTokenizer
from navillm_tpu_torch.ops import _build
from navillm_tpu_torch.ops.attention import (
    FlashAttention, attention_delta, attention_eager, flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_reference, flash_attention_bwd_dq,
    flash_attention_bwd_dq_reference, flash_attention_bwd_reference,
    flash_attention_fwd, flash_attention_fwd_reference, window_attention,
    window_attention_reference, window_mask)
from navillm_tpu_torch.ops.masking import NEG_INF
from navillm_tpu_torch.ops.matmul_q4 import (matmul_q4, matmul_q4_reference,
                                             unpack_q4)
from navillm_tpu_torch.parallel.dist import (all_gather_objects,
                                             merge_dist_results)
from navillm_tpu_torch.parallel.mesh import make_mesh, zero1_shard_opt_state
from navillm_tpu_torch.sim import WorldModel
from navillm_tpu_torch.training import train_loop as TTL
from navillm_tpu_torch.training.checkpoints import load_checkpoint
from navillm_tpu_torch.training.optim import AdamQ8, make_optimizer
from navillm_tpu_torch.training.train_loop import (make_opt_step,
                                                   train_one_epoch)
from navillm_tpu_torch.utils import hdf5
from navillm_tpu_torch.utils.config import load_yaml_text, read_args
from navillm_tpu_torch.vision.extract import FeatureExtractor, write_features
from navillm_tpu_torch.vision.vit import (ViTConfig, init_vit_params,
                                          vit_forward_features)

KERNELS = {
    "fwd": {"name": "flash_attn_fwd", "route": "cuda",
            "source": "navillm_tpu_torch/csrc/flash_attn_fwd.cu",
            "replaces": "navillm_tpu/ops/attention.py:61"},
    "dkv": {"name": "flash_attn_bwd_dkv", "route": "cuda",
            "source": "navillm_tpu_torch/csrc/flash_attn_bwd.cu",
            "replaces": "navillm_tpu/ops/attention.py:183"},
    "dq": {"name": "flash_attn_bwd_dq", "route": "cuda",
           "source": "navillm_tpu_torch/csrc/flash_attn_bwd_dq.cu",
           "replaces": "navillm_tpu/ops/attention.py:234"},
    "q4": {"name": "matmul_q4", "route": "cuda",
           "source": "navillm_tpu_torch/csrc/matmul_q4.cu",
           "replaces": "navillm_tpu/ops/matmul_q4.py:60"},
    "window": {"name": "flash_attn_window_fwd", "route": "cuda",
               "source": "navillm_tpu_torch/csrc/flash_attn_window_fwd.cu",
               "replaces": "none: JAX runs the prefix-cached window "
                           "attention through XLA (navillm_tpu/models/"
                           "llama.py chunk_forward_cached)"},
}
COUNTERS = {"fwd": flash_attention_fwd, "dkv": flash_attention_bwd_dkv,
            "dq": flash_attention_bwd_dq}
SOURCES = ["flash_attn_fwd", "flash_attn_bwd", "flash_attn_bwd_dq",
           "matmul_q4", "flash_attn_window_fwd"]
# the H100 SXM's published peaks (bf16 dense tensor cores; HBM3)
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# K1's cases: (b, t, s, nh, nkv, d, causal, q scale); random q and k make
# peaked rows, q / 8 flat ones, where a skipped key moves O the least
FLAT_Q = 0.125
FWD_CASES = [(4, t, t, 32, 32, 128, True, 1.0)
             for t in (65, 128, 640, 1000, 1024)]
FWD_CASES += [(16, 1024, 1024, 32, 32, 128, True, 1.0),  # the training shape
              (4, 1024, 1024, 32, 8, 128, True, 1.0),    # grouped-query
              (4, 640, 640, 32, 32, 64, True, 1.0),      # D = 64
              (4, 640, 1000, 32, 32, 128, False, 1.0),   # cross-attention
              (4, 1024, 1024, 32, 32, 128, True, FLAT_Q)]
# the prefill's layout: right-padded prefixes at the prefill's batch (<= 8
# rows) and the BPE prefix bucket, and at T=1024; the last row's mask is
# all false (a padding entry of prefill_rows)
FWD_RIGHT_CASES = [(8, 192, 192, 32, 32, 128, True, 1.0),
                   (8, 1024, 1024, 32, 32, 128, True, 1.0)]
# K2/K3's cases: (b, t, s, nh, nkv, d, causal, q scale): grouped-query,
# D = 64 and non-causal S != T at B = 4, then the training slice's shapes
# (B = rows per grad call; the last is the FlashAttention check's)
BWD_CASES = [(4, 1024, 1024, 32, 8, 128, True, 1.0),
             (4, 640, 640, 32, 32, 64, True, 1.0),
             (4, 640, 1000, 32, 32, 128, False, 1.0),
             (16, 640, 640, 32, 32, 128, True, 1.0),
             (16, 1024, 1024, 32, 32, 128, True, FLAT_Q),
             (16, 1024, 1024, 32, 32, 128, True, 1.0)]
# K3's delta against attention_delta: each product of two bf16 values is
# exact in f32, so the two differ only in the order of the D-term f32 sum,
# by at most ~D * 2**-24 of the row's sum of |O * dO| on each side (2**-17
# at D = 128); the limit leaves 4x of that
DELTA_RTOL = 2 ** -15
# K1 is timed at the eval slice's shapes (B = 4 slots) and the training
# slice's (B = 16 rows per grad call); K2/K3 at the training shapes
FWD_TIMED = ((4, 128), (4, 640), (4, 1024), (16, 1024))
# O, dK, dV and dQ against their plain versions: T.attn_excess, per element
# (rel T.ATTN_REL, row RMS T.ATTN_ROW, floor T.ATTN_FLOOR), on the rows that
# see a valid key. Its power is shown on every case whose rows see 256 keys
# or more: the plain version with one key (and one 64-key tile) hidden must
# fail it there.
LONG_ROW = 256
# lse is f32 on both sides and differs in summation order only (~1e-6);
# hiding a 64-key tile from a flat row of 1024 keys moves it by ~0.06
LSE_ATOL = 1e-4
# FlashAttention's three gradients against autograd through the eager path,
# which rounds P to bf16 after normalizing and runs its backward products on
# bf16 operands: a few bf16 ulps of gradients up to ~8
EAGER_GRAD_ATOL = 0.125
# the 7B gradient through the kernels vs through eager attention
MIN_GRAD_COSINE = 0.999
# the 7B-width model's depth: 16 of Vicuna-7B's 32 layers (every width, the
# vocabulary and the heads as published). A step's host time (launches per
# layer) and device time both follow the depth, and the whole run has to fit
# the chip check's 1200 s on its slowest hosts with room to spare
LLM_LAYERS = 16
N_EPISODES = 32
N_SLOTS = 4
MAX_ACTION_LEN = 10
MAX_PREFIX = 192
# the cached step's candidate logits against the uncached step's on the
# same state and prompts (phase 15), per element: tol = CACHED_LOGIT_REL *
# |ref| + CACHED_LOGIT_ROW * rms(ref's valid logits of the row). The two
# paths run the same bf16 ops in other groupings (the window's eager
# attention against K1, the prefix K/V from a prefill at another width, so
# other GEMM tilings), and once an input differs by an ulp every later
# rounding may too: each layer rounds its residual stream's inputs about
# six times (q/k/v and attention out, wo, the adds, the norms, the MLP), so
# independent errors of <= 2**-8 relative over 2 sides x 32 layers x 6
# reach ~sqrt(384) * 2**-8 ~ 2**-3.7 of the hidden's scale, and the logit,
# a dot of the hidden with one out_head column, moves by that share of the
# row's logit scale; the limit leaves ~1.6x. The logit is rounded to bf16
# once on each side (2**-7 of itself). Hiding one cached token moves the
# logits by several times this.
CACHED_LOGIT_REL = 2 ** -7
CACHED_LOGIT_ROW = 2 ** -3
# the cached-vs-uncached comparisons (phases 15, 19, 29, 41, 44) tie the row
# term to the spread of the row's valid logits instead (their standard
# deviation about the row's mean, never above the RMS, so the limit only
# tightens): a common offset of the row, which trained weights give and
# which moves no argmax, no longer widens it. Measured on the card in
# units of the row's spread (PERF.md): honest bf16-cache steps deviate at
# most 0.064 (phase 19's sampled steps; 0.031 in phase 15, 0.008 over
# phase 29's 120 steps), the last cached token hidden moves the logits
# 0.62 (phase 15). With int8 activations an int8 cache's noise flips the
# per-token rounding of the activations, so an honest W8A8 kv8 step
# deviates 0.26 there (a kv8 step on bf16 activations: 0.006), and its
# faults move the logits 0.87 (the last cached token hidden) and 0.40
# (that token's K scaled to zero): that path, new, gets its own limit.
# The bf16 one sits at 1.5x the worst honest step, 3/4 of CACHED_LOGIT_ROW.
# Those are 32-layer figures. At 16 layers the kv8 step deviates 0.097 and
# its faults move the logits 0.237 and 0.119: too close to the honest step
# to gate, so phase 41 draws its int8 tree at all 32 layers.
CACHED_LOGIT_SPREAD = 3 / 32
CACHED_LOGIT_SPREAD_A8KV8 = 0.3125
# phase 15 snapshots the 3rd step with every slot appending history, from
# a run whose stop logit is lowered by 30 (far below the others, so no
# episode stops early)
AB_SNAPSHOT = 3
AB_STOP_SHIFT = 30.0
BPE_GOLDEN = "tests/fixtures/bpe_nav_golden.json"
# training slice: 4 batches of 8 episodes, accumulation 2 -> 2 steps
TRAIN_EPISODES = 32
TRAIN_BATCH = 8
ROWS_PER_CALL = 16
# a batch's loss is its summed CE over steps / episodes: ~ln(#candidates)
# per step at random init, far below this
MAX_LOSS = 1e3
# int4 matmul, bf16 x: the f32 sums of kernel and plain version differ in
# order only, so their bf16 outputs differ by at most one bf16 ulp (2**-7 of
# the element), plus Q4_FLOOR of the largest element for values near zero;
# int8 x: every group product is exact, so the same f32 ops give the same
# result (Q4_A8_RTOL)
Q4_FLOOR = 1e-4
Q4_A8_RTOL = 1e-6
# f32 x: the JAX package's own bound for its Pallas kernel on f32 x
# (tests/test_matmul_q4.py), 1e-4 of max(|ref|, 1); the split into bf16
# high and low parts keeps x to 2^-17 of itself, rounding x to bf16 once
# misses the bound by ~20x at these shapes (measured on an H100)
Q4_F32_TOL = 1e-4
# the 7B layer matmuls (h, o): wq/wk/wv/wo, w_gate/w_up, w_down
Q4_SHAPES = ((4096, 4096), (4096, 11008), (11008, 4096))
Q4_LAYER_MATMULS = 7
# the DAgger and driver phases (18-20): BPE prompts, every unvisited node a
# candidate (max_cands = max_gmap_nodes - 1, ROADMAP C5), the eval slices'
# prefix capacity
DAGGER_DIMS = RolloutDims(max_gmap_nodes=48, max_views=44, max_cands=47,
                          max_hist=16, max_prefix=MAX_PREFIX)
# phase 19's sampler checks: N_DRAWS draws of one row, every bin within 5
# sigma of N p
N_DRAWS = 20000
# phase 19: the same forced DAgger batch through cached and uncached
# sampling gives the same loss pass inputs, so the losses agree to a bf16
# ulp and the gradients to phase 7's cosine
DAGGER_AB_LOSS_REL = 2 ** -7
# phase 20: run_training's validation split
RUN_VAL_EPISODES = 16
# phase 21: the CLI on its defaults (the card, stage multi, build_runner's
# model): 4 batches of 4, validation of CLI_VAL_EPISODES episodes
CLI_BATCH = 4
CLI_VAL_EPISODES = 8
# phases 22-25: generation at 7B width on BPE prompts. Phases 23 and 25
# evaluate GEN_EPISODES EQA episodes, each twice (its own pass and the
# oracle pass), in 2 slot groups of N_SLOTS
GEN_EPISODES = 16
GEN_MAX_ACTION_LEN = 15
# phase 22: tokens of the generate A/B and the history length of each of
# its prompts
GEN_AB_TOKENS = 32
GEN_AB_HISTORY = (0, 3, 7, 12)
# phase 24: validation episodes of each task
RUN_GEN_VAL_EPISODES = 8
# phase 24's experiment: stage multi over R2R with EQA at ratio 0, so EQA is
# validated (--test_datasets R2R EQA) and never trained (the fused trainer
# takes R2R batches)
RUN_GEN_YAML = """
Feature: {image_feat_size: 1024, angle_feat_size: 4}
Dataset:
  R2R:
    DIR: "R2R"
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
  EQA:
    DIR: "EQA"
    ANSWER_VOCAB: "annotations/answer_vocab.json"
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
Multi:
  SOURCE: ['R2R', 'EQA']
  Ratio: [1, 0]
  LOSS_COEF: {}
Model: {num_pano_layers: 2, enc_full_graph: True, expert_policy: "spl"}
Optim:
  train_max_action_len: {"R2R": %(len)d, "EQA": %(len)d}
  val_max_action_len: {"R2R": %(len)d, "EQA": %(len)d}
"""
# phases 26-28: object grounding at 7B width on BPE prompts. Objects come
# from synthetic_object_db(style, obj_feat_size 768, OG_OBJECTS per
# viewpoint), under configs/multi.yaml's max_objects (OG_MAX_OBJECTS)
OG_OBJECTS = 24
OG_MAX_OBJECTS = 70
# phase 26: the history length of each of its OG prompts (the last row also
# has no object)
OG_AB_HISTORY = (0, 2, 4, 6, 8, 10, 12, 3)
# phase 27: episodes of each task, sampled at the recipe's temperature
# (scripts/evaluation/eval_reverie.sh: --do_sample --temperature 0.01)
OG_EPISODES = 16
OG_TEMPERATURE = 0.01
# a draw at OG_TEMPERATURE leaves the argmax of its own logits only where
# their top-2 margin is within this many temperatures (Gumbel-max: the
# chance past it is below e^-20 per decision)
OG_DRAW_TEMPS = 20
# phase 28: validation episodes of each task, and the seed at which the
# MetaLoader draws REVERIE (teacher), SOON (DAgger), R2R (teacher),
# REVERIE (DAgger) for the epoch's 4 batches
OG_VAL_EPISODES = 8
OG_SEED = 3
RUN_OG_YAML = """
Feature: {image_feat_size: %(feat)d, angle_feat_size: 4,
          obj_feat_size: %(obj)d, max_objects: %(objects)d}
Dataset:
  R2R:
    DIR: "R2R"
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
  REVERIE:
    DIR: "REVERIE"
    bbox_file: "annotations/BBoxes.json"
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
  SOON:
    DIR: "SOON"
    SPLIT: {"train": "annotations/train.jsonl",
            "val_unseen": "annotations/val.jsonl"}
Multi:
  SOURCE: ['R2R', 'REVERIE', 'SOON']
  Ratio: [1, 1, 1]
  LOSS_COEF: {}
Model: {num_pano_layers: 2, enc_full_graph: True, expert_policy: "spl"}
Optim:
  train_max_action_len: {"R2R": %(len)d, "REVERIE": %(len)d, "SOON": %(len)d}
  val_max_action_len: {"R2R": %(len)d, "REVERIE": %(len)d, "SOON": %(len)d}
"""
# phases 29-32: the rest of the paper's task mix at 7B width on BPE prompts.
# Phase 29: CVDN streaming evaluation (scripts/evaluation/eval_cvdn.sh) of
# CVDN_EPISODES dialogs of 60-128 words (testing.DIALOG_WORDS, cut at 128)
# with configs/multi.yaml's val_max_action_len, under the runner's default
# dims (160 graph nodes, 99 candidates: the out_head's 100 slots, more than
# the 8x8 grid's 64 nodes; 32 history slots) with a prefix capacity that
# holds the longest dialog prefix after 30 steps (361 BPE tokens on this
# world, measured on the CPU)
CVDN_EPISODES = 16
CVDN_MAX_ACTION_LEN = 30
CVDN_PREFIX = 512
# phase 29's planted fault (one history entry hidden from the cache) must
# move the candidate logits at least this many times as far as the cached
# step's own deviation from the uncached one
FAULT_RESOLVE = 2.0
# phase 30: ScanQA questions (36 of 40-48 frames each), in batches of
# N_SLOTS, scripts/evaluation/eval_scanqa.sh's generation (20 tokens, no
# trie)
SCANQA_QUESTIONS = 16
SCANQA_NEW_TOKENS = 20
# phase 31: configs/multi.yaml's Multi stage at its ratios; at this seed the
# MetaLoader draws CVDN (teacher), CVDN (DAgger), LLaVA, ScanQA for the
# epoch's 4 batches. CVDN trains at its train_max_action_len, the other
# navigation tasks at MAX_ACTION_LEN; validation of MIX_VAL_EPISODES CVDN
# dialogs and ScanQA questions
MIX_SEED = 18175
MIX_TASKS = ["CVDN", "CVDN", "LLaVA", "ScanQA"]
MIX_TRAIN_LEN = 15
MIX_VAL_EPISODES = 8
# phase 32: the CLI at stage pretrain (seed 31: R2R_AUG, CVDN,
# REVERIE_AUG, ScanQA) and stage multi (seed 257: LLaVA, ScanQA, CVDN,
# SOON) over configs/multi.yaml's sources and ratios
CLI_MIX_SEEDS = {"pretrain": 31, "multi": 257}
# phase 32's .jsonl runs: the variables that name the Hugging Face cache
# (cleared, then HF_HOME set to a temporary one)
HF_CACHE_VARS = ("TRANSFORMERS_CACHE", "PYTORCH_TRANSFORMERS_CACHE",
                 "PYTORCH_PRETRAINED_BERT_CACHE", "HF_HUB_CACHE",
                 "HUGGINGFACE_HUB_CACHE", "HF_HOME", "XDG_CACHE_HOME")
# phase 33's tokenizer.model: the committed fixture (LLaMA's layout, as many
# pieces as BPE_VOCAB, and transformers' tokenizer.json converted from it),
# 8 episodes of streaming evaluation, and a Vicuna-sized seeded model read
# on the host
SPM_FIXTURE = Path(__file__).resolve().parent / "tests/fixtures/spm_llama"
SPM_EPISODES = 8
SPM_VICUNA_PIECES = 32000
TOK_ATTRS = ("bos_id", "eos_id", "pad_id", "unk_id", "vocab_size",
             "true_vocab_size", "cand_id", "hist_id", "obj_id", "cls_ids")
# phases 33-35: the pretrained directory holds the LLM with bpe_nav.json's
# base vocabulary (its tokenizer.json), so the 8 rows the tokenizer's
# 1024-row table adds are mean-initialised; shards of ~5 GB, as Vicuna-7B's
BPE_VOCAB = 1016
SHARD_BYTES = 5 * 10 ** 9
PRETRAINED_VAL_EPISODES = 4
# phase 34's moment gate: Adam steps of a regression on one layer slice
MOMENT_STEPS = 40
MOMENT_LR = 1e-3
MOMENT_ROWS = 256
RUN_MIX_YAML = """
Feature: {image_feat_size: %(feat)d, angle_feat_size: 4,
          obj_feat_size: %(obj)d, max_objects: %(objects)d%(stores)s}
Dataset:
  R2R:
    DIR: "R2R"
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
  REVERIE:
    DIR: "REVERIE"
    bbox_file: "annotations/BBoxes.json"
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
  CVDN:
    DIR: "CVDN"
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
  SOON:
    DIR: "SOON"
    SPLIT: {"train": "annotations/train.jsonl",
            "val_unseen": "annotations/val.jsonl"}
  ScanQA:
    DIR: "ScanQA"
    SPLIT: {"train": "annotations/train.json",
            "val_unseen": "annotations/val.json"}
  LLaVA:
    DIR: "LLaVA"
    SPLIT: {"train": "annotations/train.json"}
  R2R_AUG:
    DIR: "R2R"
    SPLIT: {"train": "annotations/train_aug.json"}
  REVERIE_AUG:
    DIR: "REVERIE"
    bbox_file: "annotations/BBoxes.json"
    SPLIT: {"train": "annotations/train_aug.json"}
Pretrain:
  SOURCE: ['R2R_AUG', 'REVERIE_AUG', 'R2R', 'REVERIE', 'SOON', 'CVDN', 'ScanQA']
  Ratio: [20, 2, 1, 1, 1, 1, 1]
  LOSS_COEF: {"R2R_AUG": 1, "REVERIE_AUG": 1}
Multi:
  SOURCE: ['R2R', 'REVERIE', 'CVDN', 'SOON', 'ScanQA', 'LLaVA']
  Ratio: [20, 5, 1, 5, 5, 5]
  LOSS_COEF: {}
Model: {num_pano_layers: 2, enc_full_graph: True, expert_policy: "spl"}
Optim:
  train_max_action_len: {"R2R": %(len)d, "REVERIE": %(len)d, "SOON": %(len)d,
                         "CVDN": %(cvdn)d, "R2R_AUG": %(len)d,
                         "REVERIE_AUG": %(len)d}
  val_max_action_len: {"R2R": %(len)d, "REVERIE": %(len)d, "SOON": %(len)d,
                       "CVDN": %(cvdn_val)d}
"""


def run_mix_yaml(feat: int, obj: int, stores: str = "",
                 aug: str = "json") -> str:
    """RUN_MIX_YAML; ``aug`` the augmented sets' file kind (json, or jsonl:
    bert-base-uncased ids)."""
    text = RUN_MIX_YAML % {"feat": feat, "obj": obj,
                           "objects": OG_MAX_OBJECTS, "stores": stores,
                           "len": MAX_ACTION_LEN, "cvdn": MIX_TRAIN_LEN,
                           "cvdn_val": CVDN_MAX_ACTION_LEN}
    return text.replace("train_aug.json", f"train_aug.{aug}")


RUN_YAML = """
Feature: %(feature)s
Dataset:
  R2R:
    DIR: "R2R"
    SPLIT: {
      "train": "annotations/train.json",
      "val_unseen": "annotations/val.json",
    }
Multi:
  SOURCE: ['R2R']
  Ratio: [1]
  LOSS_COEF: {}
Model: {num_pano_layers: 2, enc_full_graph: True, expert_policy: "spl"}
Optim:
  train_max_action_len: {"R2R": %(len)d}
  val_max_action_len: {"R2R": %(len)d}
"""


def run_yaml(feature: str) -> str:
    return RUN_YAML % {"feature": feature, "len": MAX_ACTION_LEN}


def cuda_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_clocked(fn, iters: int):
    """cuda_ms, with nvidia-smi's SM clock and power draw read while the
    timed launches run (``iters`` should keep the card busy ~0.5 s)."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    end.synchronize()
    return start.elapsed_time(end) / iters, smi


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py drives the port "
                           "on an NVIDIA H100")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"needs compute capability 9.0 (Hopper), "
                           f"found {cap}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(f"[0] device {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
    # f32 products in the plain versions run in full f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS):
    """(bound_ms, bound_by): the least time the card could take for work
    that must move ``nbytes`` and do ``flops`` at ``peak_flops``."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attn_pairs(t: int, s: int, causal: bool) -> int:
    """(query, key) pairs a full key mask leaves, per (batch, head)."""
    return t * (t + 1) // 2 if causal else t * s


def fwd_bound(b, t, s, nh, nkv, d, causal):
    """K1: 2 products of 2 D FLOP per pair; Q, K, V and the mask read once,
    O and lse written once."""
    nbytes = 2 * d * (2 * b * t * nh + 2 * b * s * nkv) + 4 * b * nh * t + b * s
    return bound(4 * d * b * nh * attn_pairs(t, s, causal), nbytes)


def window_bound(prefix_mask, win_mask, nh, nkv, d):
    """The window kernel: 2 products of 2 D FLOP per (query, visible key)
    pair and head; Q read and O written once, the K/V of each row's valid
    prefix keys and of its whole window read once, both masks read once."""
    b, s = win_mask.shape
    pairs = int(window_mask(prefix_mask, win_mask).sum())
    kv_rows = int(prefix_mask.sum()) + b * s
    nbytes = 2 * d * (2 * b * s * nh + 2 * kv_rows * nkv) \
        + prefix_mask.numel() + win_mask.numel()
    return bound(4 * d * nh * pairs, nbytes)


def bwd_bounds(b, t, nh, d):
    """(K2, K3), causal with T == S and NKV == NH. K2 does 4 products per
    pair, reads Q, K, V, dO, lse, delta and the mask and writes dK and dV;
    K3 does 3 products per pair and the 2 D FLOP per row of delta, reads
    Q, K, V, dO, O, lse and the mask and writes dQ and delta."""
    pairs = b * nh * attn_pairs(t, t, True)
    tensor = 2 * b * t * nh * d           # one [B, T, NH, D] bf16 tensor
    rows = 4 * b * nh * t                 # one [B, NH, T] f32 tensor
    return (bound(8 * d * pairs, 6 * tensor + 2 * rows + b * t),
            bound(6 * d * pairs + 2 * d * b * nh * t,
                  6 * tensor + 2 * rows + b * t))


def q4_bound(m, h, o, g, mode: str):
    """K4: 2 m h o operations (int8 tensor cores at twice the bf16 rate for
    w4a8, bf16 tensor cores otherwise: the least an f32-x product needs);
    x, the nibbles and the bf16 scales read once, y written once (bf16 for
    w4, f32 for w4a8 and f32 x)."""
    xb, yb = {"w4": (2, 2), "w4a8": (1, 4), "f32": (4, 4)}[mode]
    nbytes = m * h * xb + h * o // 2 + (h // g) * o * 2 + m * o * yb
    return bound(2 * m * h * o, nbytes,
                 2 * PEAK_FLOPS if mode == "w4a8" else PEAK_FLOPS)


def left_padded_mask(b: int, s: int, min_keys: int = 1):
    """[B, S] key masks with the first pads[i] keys of row i hidden, pads
    from none to all but ``min_keys`` keys."""
    pads = torch.linspace(0, s - min_keys, b, device="cuda").long()
    return torch.arange(s, device="cuda")[None, :] >= pads[:, None]


def right_padded_mask(b: int, s: int):
    """[B, S] key masks of right-padded prefixes: row i keeps its first
    lens[i] keys, lens from S down to 1, and the last row none."""
    lens = torch.cat([torch.linspace(s, 1, b - 1, device="cuda").long(),
                      torch.zeros(1, dtype=torch.long, device="cuda")])
    return torch.arange(s, device="cuda")[None, :] < lens[:, None]


def hide_keys(mask, start: int, width: int):
    """A copy of the [B, S] key mask with keys start..start+width-1 hidden:
    the plain version on it is what a kernel that skipped them gives."""
    hidden = mask.clone()
    hidden[:, start:start + width] = False
    return hidden


def gate(what: str, got, want, rows, faults=(), long_rows=None) -> float:
    """Holds ``got`` to ``want`` by T.attn_excess on ``rows``; each of
    ``faults`` ((name, output of the plain version with the fault planted))
    must fail the same gate on ``long_rows``. Returns the excess."""
    excess = T.attn_excess(got, want, rows)
    shown = []
    for name, bad in faults:
        r = T.attn_excess(bad, want, long_rows)
        shown.append(f"{name} {r:.1f}")
        if r <= 1:
            raise RuntimeError(f"{what}: the gate passes a planted fault "
                               f"({name}, excess {r:.3f})")
    note = (f"; planted faults fail it: {', '.join(shown)}" if shown else "")
    print(f"{what}: excess {excess:.3f} of the limit{note}")
    if not excess <= 1:
        raise RuntimeError(f"{what}: kernel disagrees with its plain version")
    return excess


def sdpa_call(q, k, v, mask, causal: bool, scale: float):
    """K1's function as one F.scaled_dot_product_attention call on the
    [B, NH, T, D] views with the same boolean mask, a [B, S] key mask or a
    [B, T, S] one (the window attention's); the library yardstick, which
    the port never calls."""
    t, s = q.shape[1], k.shape[1]
    am = mask[:, None, None, :] if mask.dim() == 2 else mask[:, None]
    if causal:
        am = am & torch.ones(t, s, dtype=torch.bool,
                             device=mask.device).tril(s - t)
    views = [x.transpose(1, 2) for x in (q, k, v)]
    # grouped-query K/V (fewer heads than q) through the call's own GQA
    kw = {"enable_gqa": True} if k.shape[2] != q.shape[2] else {}
    return lambda: F.scaled_dot_product_attention(*views, attn_mask=am,
                                                  scale=scale, **kw)


def randn(gen, *shape):
    return torch.randn(shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)


def phase_build():
    t0 = time.perf_counter()
    demangle = shutil.which("c++filt")
    for built in _build.load_all(SOURCES):
        print(f"[1] built {built.path.name} in {built.seconds:.2f} s")
        fn = None
        for ln in built.log.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1]
                if demangle:
                    fn = subprocess.run([demangle, fn], capture_output=True,
                                        text=True).stdout.strip()
            elif fn and ("registers" in ln or "spill" in ln):
                print(f"[1]   {fn}: {ln.split(':', 1)[-1].strip()}")
    print(f"[1] all kernels built in {time.perf_counter() - t0:.2f} s")


def padded_timing_mask(b: int, t: int):
    """The left-padded masks PRs 1-3 timed on: at B=4 the first 0, T/8,
    T/2 and T-1 keys of the four rows hidden (phase 2's), else
    left_padded_mask (phase 5's)."""
    if b != 4:
        return left_padded_mask(b, t)
    pads = torch.tensor([0, t // 8, t // 2, t - 1], device="cuda")
    return torch.arange(t, device="cuda")[None, :] >= pads[:, None]


def phase_kernel():
    """K1 against its plain version on FWD_CASES, then timed at FWD_TIMED
    beside its plain version and the library call. Returns (max |dO| and
    the worst gate excess over the cases, {(b, t): timings})."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    top = {"max_abs_err": 0.0, "gate_excess": 0.0}
    cases = [(c, "left") for c in FWD_CASES] \
        + [(c, "right") for c in FWD_RIGHT_CASES]
    with torch.inference_mode():
        for (b, t, s, nh, nkv, d, causal, qs), padding in cases:
            q, k, v = randn(gen, b, t, nh, d) * qs, randn(gen, b, s, nkv, d), \
                randn(gen, b, s, nkv, d)
            mask = (left_padded_mask(b, s) if padding == "left"
                    else right_padded_mask(b, s))
            scale = d ** -0.5
            o, lse = flash_attention_fwd(q, k, v, mask, causal=causal,
                                         scale=scale)
            ro, rlse = flash_attention_fwd_reference(q, k, v, mask, causal,
                                                     scale)
            torch.cuda.synchronize()
            case = (f"B={b} T={t} S={s} NH={nh} NKV={nkv} D={d} "
                    f"{'causal' if causal else 'non-causal'}"
                    f"{'' if qs == 1 else f' q x {qs}'}, {padding}-padded")
            if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
                raise RuntimeError(f"{case}: kernel output is not finite")
            if padding == "right":
                print(f"[2] {case}: the all-false row's O is finite "
                      f"(max |O| {o[-1].float().abs().max().item():.3f})")
            seen = T.visible_keys(mask, t, causal)
            rows, long_rows = seen > 0, seen >= LONG_ROW
            err_o = (o.float() - ro.float()).abs()[rows].max().item()
            err_lse = (lse - rlse).abs().transpose(1, 2)[rows].max().item()
            print(f"[2] {case}: max|dO|={err_o:.3e} (|O| up to "
                  f"{ro.float()[rows].abs().max().item():.2f}) max|dlse|="
                  f"{err_lse:.3e} (tol {LSE_ATOL})")
            faults = [(name, flash_attention_fwd_reference(
                q, k, v, hide_keys(mask, 128, w), causal, scale)[0])
                for name, w in (("one key hidden", 1),
                                ("one 64-key tile hidden", 64))
                if long_rows.any()]
            excess = gate("[2]   O", o, ro, rows, faults, long_rows)
            if err_lse > LSE_ATOL:
                raise RuntimeError(f"{case}: kernel's lse disagrees with its "
                                   f"plain version")
            top["max_abs_err"] = max(top["max_abs_err"], err_o)
            top["gate_excess"] = max(top["gate_excess"], excess)
            del faults
        timed = {}
        for b, t in FWD_TIMED:
            nh, d = 32, 128
            q, k, v = (randn(gen, b, t, nh, d) for _ in range(3))
            mask = torch.ones((b, t), dtype=torch.bool, device="cuda")
            padded = padded_timing_mask(b, t)
            scale = d ** -0.5
            ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, mask,
                                                     causal=True, scale=scale))
            padded_ms = cuda_ms(lambda: flash_attention_fwd(
                q, k, v, padded, causal=True, scale=scale))
            plain_ms = cuda_ms(lambda: flash_attention_fwd_reference(
                q, k, v, mask, True, scale), iters=5)
            library = sdpa_call(q, k, v, mask, True, scale)
            library_ms = cuda_ms(library)
            # the yardstick's own agreement with the plain version, reported
            # beside its time and not gated
            ro = flash_attention_fwd_reference(q, k, v, mask, True, scale)[0]
            lo = library().transpose(1, 2)
            lib_err = (lo.float() - ro.float()).abs().max().item()
            lib_excess = T.attn_excess(lo, ro, mask)
            bound_ms, by = fwd_bound(b, t, t, nh, nh, d, True)
            tflops = 4 * d * b * nh * attn_pairs(t, t, True) / ms / 1e9
            print(f"[2] B={b} T={t} causal, full masks: kernel {ms:.4f} ms "
                  f"({tflops:.1f} TFLOP/s; {padded_ms:.4f} ms on PR 1-3's "
                  f"left-padded masks), plain {plain_ms:.4f} ms, masked SDPA "
                  f"{library_ms:.4f} ms (max|d| {lib_err:.3e} from the plain "
                  f"version, gate excess {lib_excess:.3f}), bound "
                  f"{bound_ms:.4f} ms ({by})")
            timed[(b, t)] = {"ms": ms, "padded_ms": padded_ms,
                             "plain_ms": plain_ms, "library_ms": library_ms,
                             "library_max_abs_err": lib_err,
                             "library_gate_excess": lib_excess,
                             "bound_ms": bound_ms, "bound_by": by}
        # the prefill's call: 8 right-padded BPE prefixes of <= 192 tokens
        b, t, nh, d = 8, MAX_PREFIX, 32, 128
        q, k, v = (randn(gen, b, t, nh, d) for _ in range(3))
        mask = right_padded_mask(b, t)
        scale = d ** -0.5
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, mask, causal=True,
                                                 scale=scale))
        plain_ms = cuda_ms(lambda: flash_attention_fwd_reference(
            q, k, v, mask, True, scale), iters=5)
        library_ms = cuda_ms(sdpa_call(q, k, v, mask, True, scale))
        bound_ms, by = fwd_bound(b, t, t, nh, nh, d, True)
        print(f"[2] B={b} T={t} causal, right-padded masks (the prefill's "
              f"call): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, masked "
              f"SDPA {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})")
        timed[("prefill", b, t)] = {"ms": ms, "plain_ms": plain_ms,
                                    "library_ms": library_ms,
                                    "bound_ms": bound_ms, "bound_by": by}
    return top, timed


def window_inputs(gen, b, nh, nkv, d, app_w, suf_w, plens):
    """The prefix-cached step's window attention at the benchmark cell's
    layout: q, the cache's [B, MAX_PREFIX] K/V with row b's first plens[b]
    slots valid, an [append app_w | suffix suf_w] window with 0..app_w
    append and suf_w - 26..suf_w suffix tokens valid (padding inside the
    window), from ``gen``."""
    s, p = app_w + suf_w, MAX_PREFIX
    q = randn(gen, b, s, nh, d)
    kp, vp = randn(gen, b, p, nkv, d), randn(gen, b, p, nkv, d)
    kw, vw = randn(gen, b, s, nkv, d), randn(gen, b, s, nkv, d)
    ar = torch.arange(max(p, s), device="cuda")
    app = torch.randint(0, app_w + 1, (b,), generator=gen, device="cuda")
    suf = torch.randint(suf_w - 26, suf_w + 1, (b,), generator=gen,
                        device="cuda")
    pm = ar[None, :p] < plens[:, None]
    wm = torch.cat([ar[None, :app_w] < app[:, None],
                    ar[None, :suf_w] < suf[:, None]], dim=1)
    return q, kp, vp, pm, kw, vw, wm


def phase_window_kernel(tag=51):
    """The window kernel (csrc/flash_attn_window_fwd.cu) against its plain
    version at the prefix-cached cell's shapes (16 slots, 192-slot cache
    holding 45-115 tokens, [append 24 | suffix 49 or 75] windows, 32 query
    heads over 8 KV heads of 128) and at deepseek's MHA, by phase 2's gate;
    a prefix key and a window key hidden must each fail it on the rows
    that lose the key. Then timed at the cell's shape beside its plain
    version (the eager path the step ran before) and masked SDPA over the
    concatenated K/V with the [B, S, P+S] mask (the library yardstick).
    Returns the timed row."""
    gen = torch.Generator(device="cuda").manual_seed(51)
    out = {"max_abs_err": 0.0, "gate_excess": 0.0}
    with torch.inference_mode():
        for nh, nkv, suf_w in ((32, 8, 49), (32, 8, 75), (32, 32, 75)):
            b, d, app_w = 16, 128, 24
            plens = torch.randint(45, 116, (b,), generator=gen,
                                  device="cuda")
            args = window_inputs(gen, b, nh, nkv, d, app_w, suf_w, plens)
            q, kp, vp, pm, kw, vw, wm = args
            scale = d ** -0.5
            o = window_attention(*args, scale=scale)
            ro = window_attention_reference(*args, scale=scale)
            torch.cuda.synchronize()
            what = (f"[{tag}] window B={b} S={app_w + suf_w} P={MAX_PREFIX} "
                    f"NH={nh} NKV={nkv} D={d}")
            if not torch.isfinite(o).all():
                raise RuntimeError(f"{what}: kernel output is not finite")
            vis = window_mask(pm, wm)
            rows = vis.any(-1)
            err = (o.float() - ro.float()).abs()[rows].max().item()
            shown = []
            hid_p, hid_w = pm.clone(), wm.clone()
            hid_p[:, 30] = False
            hid_w[:, app_w + 10] = False
            for name, (pmf, wmf) in (("a prefix key hidden", (hid_p, wm)),
                                     ("a window key hidden", (pm, hid_w))):
                bad = window_attention_reference(q, kp, vp, pmf, kw, vw, wmf,
                                                 scale=scale)
                lost = (vis & ~window_mask(pmf, wmf)).any(-1)
                r = T.attn_excess(bad, ro, lost)
                shown.append(f"{name} {r:.1f}")
                if r <= 1:
                    raise RuntimeError(f"{what}: the gate passes a planted "
                                       f"fault ({name}, excess {r:.3f})")
            excess = T.attn_excess(o, ro, rows)
            print(f"{what}: max|dO|={err:.3e}, excess {excess:.3f} of the "
                  f"limit; planted faults fail it: {', '.join(shown)}")
            if not excess <= 1:
                raise RuntimeError(f"{what}: kernel disagrees with its plain "
                                   f"version")
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["gate_excess"] = max(out["gate_excess"], excess)
        # timed at the cell's widest window: GQA 32/8, S = 99
        b, nh, nkv, d, app_w, suf_w = 16, 32, 8, 128, 24, 75
        plens = torch.randint(45, 116, (b,), generator=gen, device="cuda")
        args = window_inputs(gen, b, nh, nkv, d, app_w, suf_w, plens)
        q, kp, vp, pm, kw, vw, wm = args
        scale = d ** -0.5
        ms = cuda_ms(lambda: window_attention(*args, scale=scale), iters=200)
        plain_ms = cuda_ms(lambda: window_attention_reference(
            *args, scale=scale), iters=50)
        keys, vals = torch.cat([kp, kw], 1), torch.cat([vp, vw], 1)
        library = sdpa_call(q, keys, vals, window_mask(pm, wm), False,
                            scale)
        library_ms = cuda_ms(library, iters=200)
        ro = window_attention_reference(*args, scale=scale)
        lib_err = (library().transpose(1, 2).float()
                   - ro.float()).abs()[window_mask(pm, wm).any(-1)].max() \
            .item()
    bound_ms, by = window_bound(pm, wm, nh, nkv, d)
    print(f"[{tag}] window B={b} S={app_w + suf_w} P={MAX_PREFIX} GQA "
          f"{nh}/{nkv}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, masked "
          f"SDPA {library_ms:.4f} ms (max|d| {lib_err:.3e} from the plain "
          f"version), bound {bound_ms:.4f} ms ({by}); x32 layers: kernel "
          f"{32 * ms:.3f} ms, plain {32 * plain_ms:.3f} ms a step")
    return {**out, "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err, "bound_ms": bound_ms,
            "bound_by": by}


def model_7b(tag=3, quiet: bool = False):
    tok = NavTokenizer(max_length=1024, pad_to_multiple=128)
    llm = LlamaConfig.vicuna_7b(vocab_size=32128, max_seq_len=1024,
                                num_layers=LLM_LAYERS, dtype=torch.bfloat16)
    cfg = NavModelConfig(llm=llm, pano=PanoConfig(output_size=llm.hidden_size,
                                                  dtype=torch.bfloat16,
                                                  use_obj=True))
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = NavModel(cfg, init_nav_params(cfg, gen))  # on the card
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    if not quiet:
        print(f"[{tag}] Vicuna-7B-width nav model, {llm.num_layers} "
              f"layers: {n / 1e9:.3f} B params (bf16), random init on the "
              f"card in {time.perf_counter() - t0:.1f} s")
    return tok, cfg, model


def run_eval(agent, ds, args):
    with torch.inference_mode():
        return agent.validate_streaming(
            "R2R", args, T.eval_config(MAX_ACTION_LEN),
            Dataloader(ds, N_SLOTS, shuffle=False), dataset=ds)


def slice_dims():
    """The eval slices' padded sizes (bench.py's; max_prefix 192 holds the
    BPE prompts' instruction and history prefixes)."""
    return RolloutDims(max_gmap_nodes=48, max_views=44, max_cands=12,
                       max_hist=16, max_prefix=MAX_PREFIX)


def phase_slice(tag, tok, cfg, model, tmp, warm_up: bool = True,
                window=contextlib.nullcontext, prefix_cache: bool = False,
                prompts=None, kv_int8: bool = False, runner=None,
                graph_order: bool = False, n_episodes: int = N_EPISODES):
    """Greedy streaming eval of n_episodes episodes (after a warm-up on its
    own world); gates every trajectory's start, SR/SPL and K1's launches:
    one per layer of every uncached step, or with ``prefix_cache`` one per
    layer of every prefill call, where the run must have taken the cached
    step only (no whole-prompt step). ``window()`` is entered around the
    measured run (scripts/profile_port.py traces it); ``prompts``, a list,
    receives the uncached steps' prompt texts. Returns ({instr_id:
    trajectory}, the run's counts and measures). kv_int8: the prefix cache
    in int8; ``runner`` (optional) is the runner to drive; graph_order:
    candidates in graph order (IdentityPermutation), so that an episode's
    prompts do not depend on the draws other episodes took before it and
    two runs' trajectories compare."""
    runner = runner or NavModelRunner(cfg, model, tok, dims=slice_dims())
    widths = []
    step, cached_step = runner.eval_step, runner.eval_step_cached
    tokenize = runner.tokenize_with_positions

    def eval_step(state, pano_inputs, batch, *a, **kw):
        widths.append(batch["input_ids"].shape[1])
        return step(state, pano_inputs, batch, *a, **kw)

    def eval_step_cached(state, cache, pano_inputs, batch, *a, **kw):
        widths.append((batch["app_ids"].shape[1], batch["suf_ids"].shape[1]))
        return cached_step(state, cache, pano_inputs, batch, *a, **kw)

    def tokenize_with_positions(texts, *a, **kw):
        if prompts is not None:
            prompts.extend(texts)
        return tokenize(texts, *a, **kw)

    runner.eval_step, runner.eval_step_cached = eval_step, eval_step_cached
    runner.tokenize_with_positions = tokenize_with_positions
    feat = cfg.pano.image_feat_size
    if warm_up:   # cuBLAS handles, allocator, on its own small world
        warm = T.make_r2r_world(f"{tmp}/warm", n_episodes=2 * N_SLOTS, seed=1)
        w_agent, w_ds, w_args = T.r2r_eval(warm, runner, N_SLOTS, feat,
                                           prefix_cache=prefix_cache)
        w_args.kv_int8 = kv_int8
        run_eval(w_agent, w_ds, w_args)
    anno = T.make_r2r_world(f"{tmp}/main", n_episodes=n_episodes)
    agent, ds, args = T.r2r_eval(anno, runner, N_SLOTS, feat,
                                 prefix_cache=prefix_cache)
    args.kv_int8 = kv_int8
    if graph_order:
        agent.np_rng = IdentityPermutation()
    widths.clear()
    if prompts is not None:
        prompts.clear()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = window_attention.launches = 0
    matmul_q4.launches = matmul_q4.int8_launches = 0
    L.int_mm.padded_calls = L.int_mm.padded_rows = 0
    runner.eval_steps = runner.cached_steps = runner.prefill_calls = 0
    runner.llm_token_units = 0.0
    with window():
        t0 = time.perf_counter()
        preds = run_eval(agent, ds, args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches, layers = flash_attention_fwd.launches, cfg.llm.num_layers
    counts = {"eval_steps": runner.eval_steps,
              "cached_steps": runner.cached_steps,
              "prefill_calls": runner.prefill_calls}
    steps = counts["eval_steps"] + counts["cached_steps"]

    if len(preds) != len(ds):
        raise RuntimeError(f"{len(preds)} trajectories for {len(ds)} episodes")
    for p in preds:
        start = ds.gt_trajs[p["instr_id"]][1][0]
        if p["trajectory"][0][0] != start:
            raise RuntimeError(f"{p['instr_id']} does not start at {start}")
    avg, _ = ds.eval_metrics(preds, None, "R2R")
    if not all(math.isfinite(avg[k]) for k in ("sr", "spl")):
        raise RuntimeError(f"SR/SPL not finite: {avg}")
    if prefix_cache:
        # the memory policy must have agreed: no quiet uncached fallback
        if counts["eval_steps"] or not counts["cached_steps"] \
                or not counts["prefill_calls"]:
            raise RuntimeError(f"the cached run did not take the cached "
                               f"path: {counts}")
        want, per = counts["prefill_calls"] * layers, "prefill calls"
    else:
        want, per = counts["eval_steps"] * layers, "eval steps"
    if launches != want:
        raise RuntimeError(f"kernel launches {launches} != "
                           f"{want // layers} {per} x {layers} layers")
    # the window kernel: once per layer of every cached step (bf16, D 128)
    if window_attention.launches != counts["cached_steps"] * layers:
        raise RuntimeError(f"window kernel launches "
                           f"{window_attention.launches} != "
                           f"{counts['cached_steps']} cached steps x "
                           f"{layers} layers")
    stats = {**counts, "steps": steps, "seconds": dt,
             "episodes_per_s": len(preds) / dt, "ms_per_step": 1e3 * dt / steps,
             "token_units": runner.llm_token_units,
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "int_mm_padded": (L.int_mm.padded_calls, L.int_mm.padded_rows),
             "launches": launches, "q4_launches": matmul_q4.launches,
             "window_launches": window_attention.launches}
    kind = "cached" if prefix_cache else "eval"
    widths_note = (f"[append | suffix] window widths {sorted(set(widths))}"
                   if prefix_cache else f"prompt widths {sorted(set(widths))}")
    print(f"[{tag}] {len(preds)} episodes in {dt:.3f} s = "
          f"{stats['episodes_per_s']:.3f} episodes/s; {steps} {kind} steps "
          f"of {N_SLOTS} slots, {stats['ms_per_step']:.2f} ms wall per step; "
          f"{widths_note}; {stats['token_units'] / steps:.1f} LLM tokens per "
          f"step; peak memory {stats['peak_gib']:.2f} GiB; SR "
          f"{avg['sr']:.2f} SPL {avg['spl']:.2f}; flash kernel launches "
          f"{launches} = {want // layers} {per} x {layers}")
    return {p["instr_id"]: p["trajectory"] for p in preds}, stats


def ab_batch(cfg):
    """Phase 4's inputs: 4 rows of 768 tokens, left-padded."""
    batch = T.synthetic_nav_batch(cfg, b=4, g=48, v=45, c=12, hh=16,
                                  tlen=768, seed=0)
    for row, pad in enumerate((0, 64, 300, 700)):
        batch["attention_mask"][row, :pad] = False
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def compare_logits(tag, what, model, cfg_a, cfg_b):
    """forward_navigation through two configs on phase 4's inputs."""
    dev = ab_batch(cfg_a)
    with torch.inference_mode():
        la = forward_navigation(model, cfg_a, dev)["fuse_logits"]
        lb = forward_navigation(model, cfg_b, dev)["fuse_logits"]
    if not (torch.isfinite(la).all() and torch.isfinite(lb).all()):
        raise RuntimeError("logits are not finite")
    valid = lb > NEG_INF / 2
    diff = (la - lb).abs()[valid].max().item()
    agree = (la.argmax(-1) == lb.argmax(-1)).float().mean().item()
    print(f"[{tag}] forward_navigation {what}: max |dlogit| {diff:.4e} over "
          f"{int(valid.sum())} candidate logits (range "
          f"{lb[valid].min().item():.3f}..{lb[valid].max().item():.3f}); "
          f"argmax agreement {agree:.2f}")


def phase_ab(cfg, model):
    eager = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, attn_impl="eager"))
    compare_logits(4, "kernel vs eager attention", model, cfg, eager)


def keys_seen_by(mask, t: int, causal: bool):
    """[B, S]: how many query rows see each valid key (0 for hidden keys)."""
    s = mask.shape[1]
    keys = mask[:, None, :].expand(-1, t, -1)
    if causal:
        keys = keys & mask.new_ones((t, s)).tril(s - t)
    return keys.sum(1)


def phase_backward():
    """K3 (with its delta) and K2 against their plain versions on
    BWD_CASES, FlashAttention against eager autograd, then both kernels
    timed beside their plain versions and the library call. Returns
    ({"dkv", "dq"}: max |err| and worst gate excess, {T: timings})."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    errs = {"dkv": {"max_abs_err": 0.0, "gate_excess": 0.0},
            "dq": {"max_abs_err": 0.0, "gate_excess": 0.0,
                   "delta_excess": 0.0}}
    for b, t, s, nh, nkv, d, causal, qs in BWD_CASES:
        scale = 1.0 / math.sqrt(d)
        q = randn(gen, b, t, nh, d) * qs
        k, v = randn(gen, b, s, nkv, d), randn(gen, b, s, nkv, d)
        do = randn(gen, b, t, nh, d)
        # left padding: under causal the first pads[i] rows of row i see no
        # valid key. Without causal every row of a batch row sees all of its
        # keys, so each keeps two: where every row sees one key alone, P = 1
        # and dS = P (dP - delta) is zero but for rounding, and dK there is
        # a sum of rounding noise on both sides, not a check of the kernel
        mask = left_padded_mask(b, s, 1 if causal else 2)
        case = (f"B={b} T={t} S={s} NH={nh} NKV={nkv} D={d} "
                f"{'causal' if causal else 'non-causal'}"
                f"{'' if qs == 1 else f' q x {qs}'}")
        with torch.inference_mode():
            o, lse = flash_attention_fwd(q, k, v, mask, causal=causal,
                                         scale=scale)
            dq, kdelta = flash_attention_bwd_dq(q, k, v, mask, lse, o, do,
                                                causal=causal, scale=scale)
            dk, dv = flash_attention_bwd_dkv(q, k, v, mask, lse, kdelta, do,
                                             causal=causal, scale=scale)
            delta = attention_delta(o, do)
            # the plain versions on the delta K3 computed, which is held to
            # attention_delta on its own: where a key is the only one a row
            # sees, dK (and the row's dQ) is a cancellation to rounding
            # noise that moves with delta's last bits
            args = (q, k, v, mask, lse, kdelta, do)
            rk, rv = flash_attention_bwd_dkv_reference(*args, causal, scale)
            rq = flash_attention_bwd_dq_reference(*args, causal, scale)
            torch.cuda.synchronize()
            for name, x in (("dK", dk), ("dV", dv), ("dQ", dq),
                            ("delta", kdelta)):
                if not torch.isfinite(x).all():
                    raise RuntimeError(f"{case}: {name} is not finite")
            # K3's delta against attention_delta, to DELTA_RTOL of each
            # row's sum of |O * dO|
            size = (o.float() * do.float()).abs().sum(-1).transpose(1, 2)
            d_ex = ((kdelta - delta).abs() / (DELTA_RTOL * size)).max().item()
            print(f"[5] {case}: delta max|d| "
                  f"{(kdelta - delta).abs().max().item():.3e}, "
                  f"{d_ex:.3f} of its limit")
            if not d_ex <= 1:
                raise RuntimeError(f"{case}: the dQ kernel's delta disagrees "
                                   f"with attention_delta")
            seen = T.visible_keys(mask, t, causal)
            rows_q, long_q = seen > 0, seen >= LONG_ROW
            long_k = keys_seen_by(mask, t, causal) >= LONG_ROW

            def skipped_rows(w):      # what skipping query rows gives K2
                hidden = lse.clone()
                hidden[:, :, 128:128 + w] = NEG_INF
                return flash_attention_bwd_dkv_reference(
                    q, k, v, mask, hidden, kdelta, do, causal, scale)

            dq_faults = [(name, flash_attention_bwd_dq_reference(
                q, k, v, hide_keys(mask, 128, w), lse, kdelta, do, causal,
                scale)) for name, w in (("one key hidden", 1),
                                        ("one 64-key tile hidden", 64))]
            dkv_faults = [(name, skipped_rows(w))
                          for name, w in (("one query row skipped", 1),
                                          ("one 64-row query tile skipped",
                                           64))]
            print(f"[5] {case}: max|err| dK "
                  f"{(dk.float() - rk.float()).abs().max():.3e}, dV "
                  f"{(dv.float() - rv.float()).abs().max():.3e}, dQ "
                  f"{(dq.float() - rq.float()).abs().max():.3e} (|grad| up "
                  f"to {max(x.float().abs().max() for x in (rk, rv, rq)):.2f})")
            ex = {"dkv": max(
                gate("[5]   dK", dk, rk, mask,
                     [(n, f[0]) for n, f in dkv_faults], long_k),
                gate("[5]   dV", dv, rv, mask,
                     [(n, f[1]) for n, f in dkv_faults], long_k)),
                "dq": gate("[5]   dQ", dq, rq, rows_q, dq_faults, long_q)}
            del dq_faults, dkv_faults
            errs["dq"]["delta_excess"] = max(errs["dq"]["delta_excess"], d_ex)
            for key, got, want, rows in (("dkv", (dk, dv), (rk, rv), mask),
                                         ("dq", (dq,), (rq,), rows_q)):
                e = errs[key]
                e["gate_excess"] = max(e["gate_excess"], ex[key])
                for a, w in zip(got, want):
                    e["max_abs_err"] = max(e["max_abs_err"], (
                        a.float() - w.float()).abs()[rows].max().item())
            # rows that see no valid key: dQ exactly 0; hidden keys: dK and
            # dV exactly 0
            dead = ~rows_q
            if dq[dead].float().abs().sum().item() != 0.0:
                raise RuntimeError(f"{case}: fully-masked rows got a dQ")
            if (dk[~mask].float().abs().sum().item() != 0.0
                    or dv[~mask].float().abs().sum().item() != 0.0):
                raise RuntimeError(f"{case}: hidden keys got a dK or dV")
        print(f"[5]   dQ exactly 0 on the {int(dead.sum())} rows that see no "
              f"valid key; dK and dV exactly 0 on the {int((~mask).sum())} "
              f"hidden keys")
    b, nh, d = ROWS_PER_CALL, 32, 128
    scale = 1.0 / math.sqrt(d)
    # the differentiable FlashAttention against autograd of the eager path
    # (cotangent zero on rows that see no valid key, as in the model)
    do = do * mask[:, :, None, None]
    grads = []
    for fn in (lambda *x: FlashAttention.apply(*x, mask, True, scale),
               lambda *x: attention_eager(*x, mask, True, scale)):
        xs = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        fn(*xs).backward(do)
        grads.append([x.grad.float() for x in xs])
    err = max((a - w).abs().max().item() for a, w in zip(*grads))
    print(f"[5] FlashAttention vs autograd through attention_eager (T={t}): "
          f"max|d(dq,dk,dv)| {err:.3e} (tol {EAGER_GRAD_ATOL})")
    if err > EAGER_GRAD_ATOL:
        raise RuntimeError("FlashAttention's gradient disagrees with the "
                           "eager path's")
    del grads, dk, dv, dq, rk, rv, rq
    timed = {}
    for t in (640, 1024):
        q, k, v, do = (randn(gen, b, t, nh, d) for _ in range(4))
        res = {"dkv": {}, "dq": {}}
        for masks in ("full", "padded"):
            mask = (torch.ones((b, t), dtype=torch.bool, device="cuda")
                    if masks == "full" else left_padded_mask(b, t))
            with torch.inference_mode():
                o, lse = flash_attention_fwd(q, k, v, mask, causal=True,
                                             scale=scale)
                delta = flash_attention_bwd_dq(q, k, v, mask, lse, o, do,
                                               causal=True, scale=scale)[1]
                # K3 computes dQ and delta; its plain version is the two
                # plain passes
                for key, call, ref in (
                        ("dkv", lambda: flash_attention_bwd_dkv(
                            q, k, v, mask, lse, delta, do, causal=True,
                            scale=scale),
                         lambda: flash_attention_bwd_dkv_reference(
                             q, k, v, mask, lse, delta, do, True, scale)),
                        ("dq", lambda: flash_attention_bwd_dq(
                            q, k, v, mask, lse, o, do, causal=True,
                            scale=scale),
                         lambda: flash_attention_bwd_dq_reference(
                             q, k, v, mask, lse, attention_delta(o, do), do,
                             True, scale))):
                    # ~0.5 s of launches, so nvidia-smi reads a busy card
                    iters = max(20, math.ceil(500 / cuda_ms(call, iters=5)))
                    ms, clock = cuda_ms_clocked(call, iters)
                    if masks == "full":
                        res[key].update(ms=ms, clock=clock,
                                        plain_ms=cuda_ms(ref, iters=5))
                    else:
                        res[key].update(padded_ms=ms, padded_clock=clock)
                if masks == "full":
                    delta_ms = cuda_ms(lambda: attention_delta(o, do))
                    want = flash_attention_bwd_reference(
                        q, k, v, mask, o, lse, do, True, scale)
        # the library yardstick: the backward of the masked SDPA call
        # (dQ, dK, dV and its own delta), on full masks; its agreement
        # with the plain version is reported beside it and not gated
        mask = torch.ones((b, t), dtype=torch.bool, device="cuda")
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        out = sdpa_call(*xs, mask, True, scale)()
        dot = do.transpose(1, 2)
        library_ms = cuda_ms(lambda: torch.autograd.grad(
            out, xs, dot, retain_graph=True))
        lib = torch.autograd.grad(out, xs, dot)
        lib_err = max((a.float() - w.float()).abs().max().item()
                      for a, w in zip(lib, want))
        lib_excess = max(T.attn_excess(a, w, mask) for a, w in zip(lib, want))
        del out, xs, lib, want
        for key, (bound_ms, by) in zip(("dkv", "dq"),
                                       bwd_bounds(b, t, nh, d)):
            res[key].update(library_ms=library_ms,
                            library_max_abs_err=lib_err,
                            library_gate_excess=lib_excess,
                            bound_ms=bound_ms, bound_by=by)
        timed[t] = res
        dkv, dq = res["dkv"], res["dq"]
        print(f"[5] T={t}, B={b} causal, full masks: dK/dV kernel "
              f"{dkv['ms']:.4f} ms (plain {dkv['plain_ms']:.4f}, bound "
              f"{dkv['bound_ms']:.4f}); dQ kernel with delta {dq['ms']:.4f} "
              f"ms (plain dQ + attention_delta {dq['plain_ms']:.4f}, bound "
              f"{dq['bound_ms']:.4f}); together {dkv['ms'] + dq['ms']:.4f} "
              f"ms against the masked SDPA backward's {library_ms:.4f} ms "
              f"(max|d| {lib_err:.3e} from the plain version, gate excess "
              f"{lib_excess:.3f}); the plain attention_delta pass, no longer "
              f"on the path, takes {delta_ms:.4f} ms")
        for key, name in (("dkv", "dK/dV"), ("dq", "dQ")):
            r = res[key]
            print(f"[5]   {name} on full masks {r['ms']:.4f} ms (SM clock, "
                  f"power: {r['clock']}); on PR 2's left-padded masks "
                  f"{r['padded_ms']:.4f} ms ({r['padded_clock']})")
    return errs, timed


def phase_train(tok, cfg, model, tmp, window=contextlib.nullcontext):
    """``window()`` is entered around the measured epoch. Returns (kernel
    launches of the measured run, the first grad call's arguments for
    phase 7)."""
    # every unvisited node of the graph map is a candidate (max_cands =
    # max_gmap_nodes - 1): a teacher target left out of the prompt would
    # score NEG_INF and give a loss of ~1e29
    dims = RolloutDims(max_gmap_nodes=48, max_views=44, max_cands=47,
                       max_hist=16)
    args = TrainArgs(stage="pretrain", image_feat_size=cfg.pano.image_feat_size,
                     fused_rows_per_call=ROWS_PER_CALL,
                     gradient_accumulation_step=2, seed=0)
    runner = NavModelRunner(cfg, model, tok, dims=dims,
                            feat_dropout=args.feat_dropout, seed=args.seed)
    # fill: valid keys and all keys of the grad calls' [rows, T] masks
    widths, losses, first_call, tokens, fill = [], [], [], [0], [0, 0]
    grad_call = runner.pano_navigation_train

    def recorded_grad_call(pano_inputs, seed, batch, targets, coef):
        widths.append(batch["input_ids"].shape[1])
        # tokens of the rows that carry a target (not the chunk padding)
        tokens[0] += int(batch["attention_mask"][
            targets != args.ignoreid].sum())
        fill[0] += int(batch["attention_mask"].sum())
        fill[1] += math.prod(batch["attention_mask"].shape)
        if not first_call:
            first_call.append((pano_inputs, seed, batch, targets, coef))
        return grad_call(pano_inputs, seed, batch, targets, coef)

    runner.pano_navigation_train = recorded_grad_call
    config = T.train_config(MAX_ACTION_LEN)
    tx = make_optimizer(dict(model.named_parameters()), lr=args.lr,
                        num_warmup_steps=args.num_warmup_steps,
                        grad_clip_norm=args.grad_clip_norm)
    moments = sum(x.numel() * x.element_size()
                  for st in (tx.mu, tx.nu) for x in st.values())

    def epoch(root, n_episodes, seed):
        anno = T.make_r2r_world(root, n_episodes=n_episodes, seed=seed,
                                split="train")
        agent, ds, loader = T.r2r_train(anno, runner, args, TRAIN_BATCH)
        train = agent.train

        def recorded_train(*a, **kw):
            loss = train(*a, **kw)
            losses.append(loss)
            return loss

        agent.train = recorded_train
        return train_one_epoch(
            args, config, runner, tx, make_opt_step(tx),
            MetaLoader({"R2R": (loader, 1.0)}), {"R2R": agent},
            {"R2R": ds}, 0, None, num_batches=len(loader))

    # warm-up epoch (cuBLAS handles, allocator) on its own small world
    epoch(f"{tmp}/warm", 2 * TRAIN_BATCH, seed=1)
    widths.clear()
    losses.clear()
    tokens[0] = fill[0] = fill[1] = 0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in COUNTERS.values():
        fn.launches = 0
    runner.grad_calls = 0
    with window():
        t0 = time.perf_counter()
        avg_loss, norms = epoch(f"{tmp}/main", TRAIN_EPISODES, seed=0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    calls, layers = runner.grad_calls, cfg.llm.num_layers
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    n_batches = TRAIN_EPISODES // TRAIN_BATCH
    if len(losses) != n_batches or not all(
            math.isfinite(float(x)) and 0 < float(x) < MAX_LOSS
            for x in losses):
        raise RuntimeError(f"losses {[float(x) for x in losses]}: not all "
                           f"finite and in (0, {MAX_LOSS})")
    norms = [float(n) for n in norms]
    if len(norms) != n_batches // args.gradient_accumulation_step or not all(
            math.isfinite(n) and n > 0 for n in norms):
        raise RuntimeError(f"global gradient norms {norms}")
    if launches["dkv"] != calls * layers or launches["dq"] != calls * layers:
        raise RuntimeError(f"backward launches {launches} != {calls} grad "
                           f"calls x {layers} layers")
    # remat: each grad call runs every layer's forward once, and once more
    # when the backward recomputes the layer, so K1 launches twice per
    # layer; the pano encoder's attention is eager and launches none
    if launches["fwd"] != 2 * calls * layers:
        raise RuntimeError(f"forward launches {launches['fwd']} != 2 x "
                           f"{calls} grad calls x {layers} layers")
    tokens = tokens[0]
    print(f"[6] trained {TRAIN_EPISODES} episodes in {dt:.3f} s = "
          f"{TRAIN_EPISODES / dt:.3f} episodes/s; {len(norms)} optimizer "
          f"steps, {1e3 * dt / len(norms):.1f} ms wall per step; {calls} "
          f"grad calls of {ROWS_PER_CALL} rows, prompt widths "
          f"{sorted(set(widths))}, key masks {100 * fill[0] / fill[1]:.1f}%"
          f" valid; {tokens} trained tokens = "
          f"{tokens / dt:.0f} tokens/s; peak memory {peak:.2f} GiB "
          f"(AdamW moments {moments / 2 ** 30:.2f} GiB); losses "
          f"{[round(float(x), 4) for x in losses]} (mean {avg_loss:.4f}); "
          f"grad norms {[round(n, 4) for n in norms]}; launches {launches}")
    del tx
    return launches, first_call[0]


def phase_grad_ab(tok, cfg, model, call):
    """One grad call through the kernels and through eager attention."""
    last = cfg.llm.num_layers - 1
    watch = {"llm.layers.wq[0]": lambda m: m.llm.layers.wq.grad[0],
             f"llm.layers.wq[{last}]": lambda m: m.llm.layers.wq.grad[last],
             "out_head.w": lambda m: m.out_head.w.grad,
             "pano.mapper.w": lambda m: m.pano.mapper.w.grad}
    res = {}
    for impl in ("auto", "eager"):
        cfg_i = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, attn_impl=impl),
            pano=dataclasses.replace(cfg.pano, hidden_dropout_prob=0.0))
        runner = NavModelRunner(cfg_i, model, tok, feat_dropout=0.0)
        runner.zero_grads()
        loss = float(runner.pano_navigation_train(*call))
        res[impl] = (loss, {k: f(model).float().clone()
                            for k, f in watch.items()})
    (lk, gk), (le, ge) = res["auto"], res["eager"]
    print(f"[7] one grad call of {ROWS_PER_CALL} rows: loss kernel {lk:.6f} "
          f"eager {le:.6f} (diff {abs(lk - le):.3e})")
    for name in watch:
        a, w = gk[name].flatten(), ge[name].flatten()
        rel = ((a - w).norm() / w.norm()).item()
        cos = torch.nn.functional.cosine_similarity(a, w, dim=0).item()
        print(f"[7] {name}: rel L2 err {rel:.3e}, cosine {cos:.6f} "
              f"(|g| {w.norm().item():.4e})")
        if not cos >= MIN_GRAD_COSINE:
            raise RuntimeError(f"{name}: gradient cosine {cos} < "
                               f"{MIN_GRAD_COSINE}")


def int4pack(q4p, s):
    """The port's int4 weight (nibbles [h, o/2], scales [h/G, o]) in the
    layout of torch's own int4 matmul, torch._weight_int4pack_mm: packed
    [o, h] nibbles shifted by +8 and [h/G, o, 2] scales with zero points 0
    (that op dequantizes (q - 8) * scale + zero)."""
    w = (unpack_q4(q4p).to(torch.int32) + 8).t().contiguous()
    packed = torch._convert_weight_to_int4pack(
        (w[:, ::2] << 4 | w[:, 1::2]).to(torch.uint8), 8)
    sz = torch.stack([s, torch.zeros_like(s)], -1).to(torch.bfloat16)
    return packed, sz.contiguous()


def phase_q4_kernel(tag=8, rows=(4096, 3584, 7),
                    modes=("w4", "w4a8", "f32"), shapes=Q4_SHAPES):
    """K4 against its plain version at the 7B layer shapes, ``rows`` the
    m of x: bf16 x (w4), int8 x (w4a8) and f32 x (f32; values that bf16
    does not hold, held to the JAX test's bound, 1e-4 of max(|ref|, 1)).
    Returns {(m, h, o, mode): row}, row holding max_abs_err, ms, plain_ms,
    library_ms (w4: with the call's max |d| from the plain version and how
    far beyond K4's tolerance; w4a8 and f32: None, with the reason in
    ``library``), bound_ms and bound_by."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    has_lib = all(hasattr(torch, f) for f in ("_weight_int4pack_mm",
                                             "_convert_weight_to_int4pack"))
    out = {}
    for h, o in shapes:
        w = torch.randn((h, o), generator=gen, device="cuda",
                        dtype=torch.bfloat16) * h ** -0.5
        q4p, s = _quant_one4(w)
        g = h // s.shape[0]
        packed = int4pack(q4p, s) if has_lib else None
        for m in rows:
            x = torch.randn((m, h), generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            dense_ms = cuda_ms(lambda: x @ w)
            # f32 x off bf16's grid (a deterministic relative nudge)
            wiggle = torch.sin(torch.arange(m * h, device="cuda",
                                            dtype=torch.float32)).view(m, h)
            xf = x.float() * (1 + 2 ** -9 * wiggle)
            for mode, a in (("w4", x), ("w4a8", _act_q(x)[0]), ("f32", xf)):
                if mode not in modes:
                    continue
                y = matmul_q4(a, q4p, s)
                ref = matmul_q4_reference(a, q4p, s)
                torch.cuda.synchronize()
                if not torch.isfinite(y).all():
                    raise RuntimeError(f"{mode} m={m} h={h} o={o}: kernel "
                                       f"output is not finite")
                top = ref.float().abs()
                tol = {"w4": lambda: 2 ** -7 * top + Q4_FLOOR * top.max(),
                       "w4a8": lambda: Q4_A8_RTOL * top,
                       "f32": lambda: torch.full_like(
                           top, Q4_F32_TOL * max(top.max().item(), 1.0))
                       }[mode]()
                d = (y.float() - ref.float()).abs()
                rel = (d / top.clamp(min=Q4_FLOOR * top.max().item())).max()
                ms = cuda_ms(lambda: matmul_q4(a, q4p, s))
                plain_ms = cuda_ms(lambda: matmul_q4_reference(a, q4p, s),
                                   iters=5)
                bound_ms, by = q4_bound(m, h, o, g, mode)
                err = d.max().item()
                row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "library_ms": None, "bound_ms": bound_ms,
                       "bound_by": by}
                lib_note = ""
                if mode == "w4a8":
                    row["library"] = ("none: no PyTorch call multiplies int8 "
                                      "activations by int4 weights")
                elif mode == "f32":
                    row["library"] = ("none: no PyTorch call multiplies f32 "
                                      "activations by int4 weights")
                    row["bf16_x_ms"] = out[(m, h, o, "w4")]["ms"] \
                        if (m, h, o, "w4") in out else None
                elif not has_lib:
                    row["library"] = ("none: this torch has no "
                                      "_weight_int4pack_mm")
                else:
                    # the yardstick's agreement with the plain version is
                    # reported beside its time and not gated (it rounds the
                    # dequantized weight to bf16)
                    lib = lambda: torch._weight_int4pack_mm(x, packed[0], g,
                                                            packed[1])
                    lib_ms = cuda_ms(lib)
                    ld = (lib().float() - ref.float()).abs()
                    over = (ld - tol).max().item()
                    row.update(library_ms=lib_ms,
                               library_max_abs_err=ld.max().item(),
                               library_beyond_tol=max(over, 0.0),
                               library="torch._weight_int4pack_mm on the "
                                       "repacked weight")
                    lib_note = (f", torch._weight_int4pack_mm {lib_ms:.4f} "
                                f"ms (max|d| {ld.max().item():.3e} from the "
                                f"plain version; beyond K4's tolerance by "
                                f"{max(over, 0.0):.3e})")
                print(f"[{tag}] {mode} m={m} h={h} o={o}: max|d|={err:.3e} "
                      f"(max |d|/|ref| {rel.item():.3e}, |ref| up to "
                      f"{top.max().item():.2f}); kernel {ms:.4f} ms, plain "
                      f"{plain_ms:.4f} ms, dense bf16 matmul {dense_ms:.4f} "
                      f"ms{lib_note}; bound {bound_ms:.4f} ms ({by}); "
                      f"{2 * m * h * o / ms / 1e9:.1f} TFLOP/s")
                if (d - tol).max().item() > 0:
                    raise RuntimeError(f"{mode} m={m} h={h} o={o}: kernel "
                                       f"disagrees with its plain version")
                out[(m, h, o, mode)] = row
    return out


def quantize_model(cfg, model):
    """The model with its LLM in int4 (bits=4), quantized on the card;
    the bf16 LLM's storage is freed by the caller dropping ``model``."""
    for p in model.parameters():       # phase 6's gradients
        p.grad = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qmodel = NavModel(cfg, quantize_nav_params(model, bits=4))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0

    def nbytes(m):
        return sum(p.numel() * p.element_size() for p in m.parameters())
    print(f"[9] LLM quantized to int4 on the card in {dt:.2f} s: "
          f"{nbytes(model.llm) / 1e9:.3f} GB -> {nbytes(qmodel.llm) / 1e9:.3f}"
          f" GB (layer matmuls int4, embed and lm_head int8)")
    return qmodel


def phase_q4_slice(tag, tok, cfg, qmodel, tmp, dense_trajs, warm_up,
                   window=contextlib.nullcontext, prefix_cache: bool = False,
                   dense_tag: int = 3):
    """K4 launches once per layer matmul of every LLM pass: each uncached
    step, or each prefill call and cached step. Returns (the int4 kernel's
    launches in the measured run, the trajectories, phase_slice's
    stats)."""
    trajs, stats = phase_slice(tag, tok, cfg, qmodel, tmp, warm_up=warm_up,
                               window=window, prefix_cache=prefix_cache)
    launches, int8 = matmul_q4.launches, matmul_q4.int8_launches
    passes = stats["steps"] + stats["prefill_calls"]
    want = passes * cfg.llm.num_layers * Q4_LAYER_MATMULS
    if launches != want:
        raise RuntimeError(f"int4 kernel launches {launches} != {passes} "
                           f"LLM passes x {cfg.llm.num_layers} layers x "
                           f"{Q4_LAYER_MATMULS}")
    if int8 != (launches if cfg.llm.act_int8 else 0):
        raise RuntimeError(f"{int8} of {launches} int4 launches had int8 "
                           f"activations (act_int8={cfg.llm.act_int8})")
    same = sum(trajs[k] == dense_trajs[k] for k in trajs)
    what = (f"({stats['prefill_calls']} prefill calls + {stats['steps']} "
            f"cached steps)" if prefix_cache else f"{passes} steps")
    ref = " (bf16, before training moved the weights)" if dense_tag == 3 \
        else ""
    print(f"[{tag}] int4 kernel launches {launches} = {what} x "
          f"{cfg.llm.num_layers} x {Q4_LAYER_MATMULS} (int8 activations: "
          f"{int8}); trajectories equal to phase {dense_tag}'s{ref}: {same} "
          f"of {len(trajs)}")
    return launches, trajs, stats


def phase_bpe_check(byte_tok, bpe, prompts):
    """The port's BPE (plain Python; the card's machine has no
    `tokenizers`) against the ids the JAX package's tokenizer gave on the
    CPU (tests/fixtures/bpe_nav_golden.json, which a CPU test holds equal
    to JAX's output); decode(encode(x)) == x; the prompt width, byte
    against BPE, on phase 3's prompts."""
    golden = json.loads((Path(__file__).resolve().parent
                         / BPE_GOLDEN).read_text())
    bad = [t for t, ids in zip(golden["texts"], golden["ids"])
           if bpe.encode(t) != ids]
    if bad or not golden["texts"]:
        raise RuntimeError(f"BPE ids differ from the golden ids on "
                           f"{len(bad)} of {len(golden['texts'])} texts: "
                           f"{bad[:2]!r}")
    texts = sorted(set(prompts)) + golden["texts"]
    be = bpe.backend
    lost = [t for t in texts if be.decode(be.encode(t), False) != t]
    if lost or not prompts:
        raise RuntimeError(f"decode(encode(x)) != x on {len(lost)} texts: "
                           f"{lost[:2]!r}")
    nb = sum(len(byte_tok.encode(p)) for p in prompts) / len(prompts)
    nt = sum(len(bpe.encode(p)) for p in prompts) / len(prompts)
    print(f"[12] BPE ids equal the golden ids on all {len(golden['texts'])} "
          f"texts; decode(encode(x)) == x on {len(texts)} texts; phase 3's "
          f"{len(prompts)} prompts: {nb:.1f} byte tokens against {nt:.1f} "
          f"BPE tokens on average ({nb / nt:.2f}x)")


WINDOW_KEYS = ("app_ids", "app_mask", "app_hist_pos", "suf_ids", "suf_mask",
               "cand_positions", "cls_pos")


def logit_tol(want):
    """(tol, valid): the CACHED_LOGIT_* bound per element of want's valid
    logits, 0 on the masked ones."""
    valid = want > NEG_INF / 2
    w = torch.where(valid, want, torch.zeros((), device=want.device))
    rms = (w.square().sum(-1, keepdim=True)
           / valid.sum(-1, keepdim=True).clamp(min=1)).sqrt()
    tol = CACHED_LOGIT_REL * w.abs() + CACHED_LOGIT_ROW * rms
    return torch.where(valid, tol, torch.zeros((), device=want.device)), valid


def logit_excess(got, want) -> float:
    """The worst |got - want| / tol over want's valid logits (the
    CACHED_LOGIT_* bound); both must mask the same logits."""
    tol, valid = logit_tol(want)
    if not torch.equal(got > NEG_INF / 2, valid):
        return math.inf
    return ((got - want).abs() / tol)[valid].max().item()


def cached_logit_tol(want, spread=CACHED_LOGIT_SPREAD):
    """(tol, valid): the cached-vs-uncached bound per element of want's
    valid logits, CACHED_LOGIT_REL * |ref| + ``spread`` * the standard
    deviation of the row's valid logits (0 on the masked ones)."""
    valid = want > NEG_INF / 2
    zero = torch.zeros((), device=want.device)
    n = valid.sum(-1, keepdim=True).clamp(min=1)
    w = torch.where(valid, want, zero)
    dev = torch.where(valid, want - w.sum(-1, keepdim=True) / n, zero)
    std = (dev.square().sum(-1, keepdim=True) / n).sqrt()
    tol = CACHED_LOGIT_REL * w.abs() + spread * std
    return torch.where(valid, tol, zero), valid


def spread_need(got, want) -> float:
    """The spread constant at which ``got`` would sit exactly on the
    cached limit: max over want's valid logits of (|got - want| -
    CACHED_LOGIT_REL |want|) / the row's spread (what the printouts give
    beside each excess, the margin of a fault or of the honest step)."""
    tol, valid = cached_logit_tol(want, 1.0)
    rel = CACHED_LOGIT_REL * want.abs()
    std = tol - rel
    if not torch.equal(got > NEG_INF / 2, valid):
        return math.inf
    need = ((got - want).abs() - rel) / std.clamp(min=1e-30)
    return need[valid].max().item()


def cached_logit_excess(got, want, spread=CACHED_LOGIT_SPREAD) -> float:
    """The worst |got - want| / tol over want's valid logits under
    cached_logit_tol; both must mask the same logits."""
    tol, valid = cached_logit_tol(want, spread)
    if not torch.equal(got > NEG_INF / 2, valid):
        return math.inf
    return ((got - want).abs() / tol)[valid].max().item()


def phase_cached_ab(bpe, cfg, model, tmp, tag=15, kv_int8=False):
    """One slot group's cached step against the uncached step on the same
    state and prompts. A cached run on its own small world, its stop logit
    lowered by AB_STOP_SHIFT so that the episodes run on, snapshots its
    AB_SNAPSHOT-th step on which every slot is active and appends history
    (the cache built by a prefill and several appends); with the stop
    logit restored, that step is replayed through eval_step_cached and
    through eval_step on the same prompts. The candidate logits are gated
    per element (cached_logit_tol; CACHED_LOGIT_SPREAD_A8KV8 on an int8
    cache under int8 activations); the same cached step with the last
    cached token hidden from the prefix (plen - 1) must fail the gate, and
    on an int8 cache under bf16 activations (kv_int8, phase 41's
    weight-only run) so must the step with that token's K scaled to zero
    (its K scales set to 0). Under W8A8 that fault is not planted: it moves
    the logits ~0.2 row spreads, the size of the noise by which two exact
    attentions part there (PERF.md §6). Returns {name: excess} of
    the honest step and the faults."""
    spread = CACHED_LOGIT_SPREAD_A8KV8 if kv_int8 and cfg.llm.act_int8 \
        else CACHED_LOGIT_SPREAD
    zero_k_fault = kv_int8 and not cfg.llm.act_int8
    runner = NavModelRunner(cfg, model, bpe, dims=slice_dims())
    feat = cfg.pano.image_feat_size
    anno = T.make_r2r_world(f"{tmp}/ab", n_episodes=2 * N_SLOTS, seed=2)
    agent, ds, args = T.r2r_eval(anno, runner, N_SLOTS, feat,
                                 prefix_cache=True)
    args.kv_int8 = kv_int8
    snap, seen, found = {}, [], [0]
    step, windows = runner.eval_step_cached, agent._cached_prompt_windows

    def clone(d):
        return {k: v.clone() for k, v in d.items()}

    def eval_step_cached(state, cache, pano, batch, reset, cur, cand, active,
                         *a, **kw):
        if active.all() and batch["app_mask"].any(1).all():
            found[0] += 1
        if not snap and found[0] == AB_SNAPSHOT:
            snap.update(state=clone(state), cache=clone(cache), pano=pano,
                        batch=batch, args=(reset.copy(), cur.copy(),
                                           cand.copy(), active.copy()),
                        prompts=list(seen[-1]))
        return step(state, cache, pano, batch, reset, cur, cand, active,
                    *a, **kw)

    def cached_prompt_windows(slots, prompts, *a):
        seen.append(list(prompts))
        return windows(slots, prompts, *a)

    runner.eval_step_cached = eval_step_cached
    agent._cached_prompt_windows = cached_prompt_windows
    stop_b = model.out_head.b
    with torch.no_grad():
        stop_b0 = stop_b[0].clone()
        stop_b[0] -= AB_STOP_SHIFT
        try:
            run_eval(agent, ds, args)
        finally:
            stop_b[0] = stop_b0
    if not snap:
        raise RuntimeError("no cached step with history to compare")

    with torch.inference_mode():
        def cached(hide: int = 0, zero_k: bool = False):
            cache = clone(snap["cache"])
            if zero_k:             # the last cached token's K scaled to 0
                rows = torch.arange(N_SLOTS, device=cache["plen"].device)
                cache["pkv_ks"][:, rows, cache["plen"].long() - 1] = 0.0
            cache["plen"] -= hide
            return step(clone(snap["state"]), cache, snap["pano"],
                        snap["batch"], *snap["args"])[3]

        got = cached()
        faults = {"last cached token hidden": cached(hide=1)}
        if zero_k_fault:
            faults["last cached token's K scaled to zero"] = \
                cached(zero_k=True)
        toks, cand_pos, hist_pos, cls_pos = runner.tokenize_with_positions(
            snap["prompts"])
        batch = {k: v for k, v in snap["batch"].items()
                 if k not in WINDOW_KEYS}
        batch.update(input_ids=toks.input_ids,
                     attention_mask=toks.attention_mask,
                     cand_positions=cand_pos, hist_positions=hist_pos,
                     cls_pos=cls_pos)
        want = runner.eval_step(clone(snap["state"]), snap["pano"], batch,
                                *snap["args"])[2]
        torch.cuda.synchronize()
    if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
        raise RuntimeError(f"[{tag}] cached-step A/B: logits are not finite")
    valid = want > NEG_INF / 2
    excess = cached_logit_excess(got, want, spread)
    out = {"honest": excess,
           "max_dlogit": (got - want).abs()[want > NEG_INF / 2].max().item()}
    n_hist = int(snap["batch"]["app_mask"].sum(1).min())
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    notes = []
    for name, bad in faults.items():
        out[name] = cached_logit_excess(bad, want, spread)
        notes.append(f"{name}: excess {out[name]:.2f} (spread "
                     f"{spread_need(bad, want):.4f}; the RMS limit's excess "
                     f"{logit_excess(bad, want):.2f})")
    kind = ("W8A8" if cfg.llm.act_int8 else "bf16 activations") \
        + (" on an int8 cache" if kv_int8 else ", bf16 cache")
    print(f"[{tag}] cached step ({kind}) vs uncached step ({N_SLOTS} slots, "
          f"each appending >= {n_hist} history tokens, at the slots' step "
          f"{AB_SNAPSHOT} or later; prompts of {toks.input_ids.shape[1]} "
          f"tokens, windows {snap['batch']['app_ids'].shape[1]} | "
          f"{snap['batch']['suf_ids'].shape[1]}): max |dlogit| "
          f"{(got - want).abs()[valid].max().item():.4e} over "
          f"{int(valid.sum())} candidate logits (range "
          f"{want[valid].min().item():.3f}..{want[valid].max().item():.3f}), "
          f"excess {excess:.3f} of the limit (spread "
          f"{spread_need(got, want):.4f} of {spread:.4f}; the RMS limit's "
          f"excess "
          f"{logit_excess(got, want):.3f}); argmax agreement {agree:.2f}; "
          f"planted faults fail it: {'; '.join(notes)}")
    for name, f_excess in out.items():
        if name in faults and f_excess <= 1:
            raise RuntimeError(f"[{tag}] cached-step A/B: the gate passes a "
                               f"planted fault ({name}, excess "
                               f"{f_excess:.3f})")
    if not excess <= 1:
        raise RuntimeError(f"[{tag}] cached-step A/B: the cached step "
                           f"disagrees with the uncached step")
    return out


def report_cached(tag, cfg, trajs, stats, ref_trajs, ref_stats, ref_tag):
    """The cached run beside the uncached one on the same tokenizer."""
    c = cfg.llm
    cache_bytes = (2 * c.num_layers * N_SLOTS * MAX_PREFIX * c.num_kv_heads
                   * c.head_dim * c.dtype.itemsize)
    same = sum(trajs[k] == ref_trajs[k] for k in trajs)
    tok_c = stats["token_units"] / stats["steps"]
    tok_u = ref_stats["token_units"] / ref_stats["steps"]
    print(f"[{tag}] against phase {ref_tag} (uncached): {tok_c:.1f} against "
          f"{tok_u:.1f} LLM tokens per step ({tok_u / tok_c:.2f}x fewer, "
          f"prefills included); {stats['ms_per_step']:.2f} against "
          f"{ref_stats['ms_per_step']:.2f} ms wall per step; "
          f"{stats['episodes_per_s']:.3f} against "
          f"{ref_stats['episodes_per_s']:.3f} episodes/s; peak memory "
          f"{stats['peak_gib']:.2f} against {ref_stats['peak_gib']:.2f} GiB; "
          f"cache {cache_bytes} bytes ({cache_bytes / 2 ** 30:.3f} GiB) per "
          f"stream of {N_SLOTS} slots x {MAX_PREFIX} tokens; trajectories "
          f"equal to phase {ref_tag}'s: {same} of {len(trajs)}")


def cuda_timed(fn, sink):
    """fn, with each call's wall seconds (card synchronized on both
    sides) appended to ``sink``."""
    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        sink.append(time.perf_counter() - t0)
        return out
    return wrapped


def zero_counters(runner):
    for fn in COUNTERS.values():
        fn.launches = 0
    matmul_q4.launches = matmul_q4.int8_launches = 0
    L.int_mm.padded_calls = L.int_mm.padded_rows = 0
    runner.eval_steps = runner.cached_steps = runner.prefill_calls = 0
    runner.grad_calls = runner.gen_grad_calls = runner.generate_calls = 0
    runner.og_calls = runner.og_grad_calls = runner.forward_calls = 0
    runner.sampling_quantizations, runner.sampling_quant_s = 0, 0.0
    runner.llm_token_units = 0.0


def check_launches(tag, runner, layers):
    """K1 once per layer of every prefill (the prefix cache's and each
    generate call's), uncached step, object-grounding forward, other
    forward without a gradient (the host-memory and batched evaluation
    steps: runner.forward_calls) and grad call's forward, and once more
    under remat (the recomputed forward); K2 and K3 once per layer of every
    grad call, the generation and OG heads' included. Returns the
    launches."""
    launches = {k: fn.launches for k, fn in COUNTERS.items()}
    passes = runner.prefill_calls + runner.eval_steps + runner.generate_calls \
        + runner.og_calls + runner.forward_calls
    calls = runner.grad_calls
    fwd_per_call = 2 if runner.cfg.llm.remat else 1
    want = {"fwd": layers * (passes + fwd_per_call * calls),
            "dkv": layers * calls, "dq": layers * calls}
    if launches != want:
        raise RuntimeError(f"[{tag}] kernel launches {launches} != {want} "
                           f"({runner.prefill_calls} prefills + "
                           f"{runner.eval_steps} uncached steps + "
                           f"{runner.generate_calls} generate calls + "
                           f"{runner.og_calls} OG calls + "
                           f"{runner.forward_calls} forwards, {calls} grad "
                           f"calls, {layers} layers)")
    return launches


def check_q4(tag, runner, layers, decodes: int = 0) -> int:
    """K4 (matmul_q4) Q4_LAYER_MATMULS times per layer of every LLM pass on
    an int4 tree (uncached and cached steps, prefills, generate calls'
    prefills and their ``decodes`` decode steps, OG calls, other forwards),
    every launch with int8 x under act_int8, and none on another tree.
    Returns the launches."""
    passes = (runner.eval_steps + runner.cached_steps + runner.prefill_calls
              + runner.generate_calls + runner.og_calls
              + runner.forward_calls + decodes)
    int4 = is_quantized(runner.model) and weight_bits(runner.model) == 4
    want = passes * layers * Q4_LAYER_MATMULS if int4 else 0
    int8 = want if runner.cfg.llm.act_int8 else 0
    if (matmul_q4.launches, matmul_q4.int8_launches) != (want, int8):
        raise RuntimeError(f"[{tag}] int4 kernel launches "
                           f"{matmul_q4.launches} ({matmul_q4.int8_launches} "
                           f"with int8 x) != {passes} LLM passes x {layers} x "
                           f"{Q4_LAYER_MATMULS} ({int8})")
    return matmul_q4.launches


def dagger_setup(tok, cfg, model):
    """The JAX defaults of the DAgger half (fused_dagger, dagger_streams=2,
    dagger_prefix_cache=True) at stage multi."""
    args = TrainArgs(stage="multi", image_feat_size=cfg.pano.image_feat_size,
                     fused_rows_per_call=ROWS_PER_CALL,
                     gradient_accumulation_step=2, seed=0)
    runner = NavModelRunner(cfg, model, tok, dims=DAGGER_DIMS,
                            feat_dropout=args.feat_dropout, seed=args.seed)
    return args, runner


def phase_dagger(bpe, cfg, model, tmp, window=contextlib.nullcontext,
                 tag=18, sample_quant=False):
    """Phase 18: train_one_epoch at stage multi (teacher, then the fused
    DAgger: sampling on the card through the prefix-cached step, then the
    fused loss pass), a warm-up epoch, then 4 batches of 8. Phase 43 the
    same with --dagger_sample_quant: every sampling step and prefill on the
    runner's W8A8 policy, made once per optimizer step. Returns (the
    measured run's kernel launches, its measures)."""
    args, runner = dagger_setup(bpe, cfg, model)
    args = dataclasses.replace(args, dagger_sample_quant=sample_quant)
    layers = cfg.llm.num_layers
    rec = {"draws": [], "sample_tokens": 0.0, "teacher_s": [],
           "dagger_s": [], "dagger_lp": [],
           "loss_pass": {"teacher": [], "sample": []}, "losses": [],
           "policy": {True: 0, False: 0}}
    cached, plain, prefill = (runner.eval_step_cached, runner.eval_step,
                              runner.prefill)

    def counted(fn, step):
        def wrapped(*a, **kw):
            rec["policy"][bool(kw.get("quant", False))] += 1
            before = runner.llm_token_units
            out = fn(*a, **kw)
            rec["sample_tokens"] += runner.llm_token_units - before
            if step:          # (a_t, logits) of the step, active rows
                rec["draws"].append((out[-2], out[-1], kw["active_mask"]))
            return out
        return wrapped

    runner.eval_step_cached = counted(cached, True)
    runner.eval_step = counted(plain, True)
    runner.prefill = counted(prefill, False)
    loss_pass = FT._fused_trajectory_train

    def timed_loss_pass(*a, **kw):
        return cuda_timed(loss_pass, rec["loss_pass"][
            kw.get("feedback", "teacher")])(*a, **kw)

    config = T.train_config(MAX_ACTION_LEN)
    tx = make_optimizer(dict(model.named_parameters()), lr=args.lr,
                        num_warmup_steps=args.num_warmup_steps,
                        grad_clip_norm=args.grad_clip_norm)
    agents = []

    def epoch(root, n_episodes, seed):
        anno = T.make_r2r_world(root, n_episodes=n_episodes, seed=seed,
                                split="train")
        agent, ds, loader = T.r2r_train(anno, runner, args, TRAIN_BATCH)
        agents.append(agent)
        train = agent.train

        def recorded_train(name, batch, a, config, dataset, step=0, **kw):
            sink = rec["dagger_s"] if step % 2 else rec["teacher_s"]
            n_lp = len(rec["loss_pass"]["sample"])
            loss = cuda_timed(train, sink)(name, batch, a, config, dataset,
                                           step=step, **kw)
            if step % 2:       # the batch's loss passes, one per slot group
                rec["dagger_lp"].append(sum(rec["loss_pass"]["sample"][n_lp:]))
            rec["losses"].append(loss)
            return loss

        agent.train = recorded_train
        return train_one_epoch(
            args, config, runner, tx, make_opt_step(tx),
            MetaLoader({"R2R": (loader, 1.0)}), {"R2R": agent},
            {"R2R": ds}, 0, None, num_batches=len(loader))

    FT._fused_trajectory_train = timed_loss_pass
    try:
        epoch(f"{tmp}/warm", 2 * TRAIN_BATCH, seed=1)
        agents.clear()              # and the warm-up agent's caches
        for v in (rec["draws"], rec["teacher_s"], rec["dagger_s"],
                  rec["dagger_lp"], rec["loss_pass"]["teacher"],
                  rec["loss_pass"]["sample"], rec["losses"]):
            v.clear()
        rec["sample_tokens"] = 0.0
        rec["policy"] = {True: 0, False: 0}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters(runner)
        with window():
            t0 = time.perf_counter()
            avg_loss, norms = epoch(f"{tmp}/main", TRAIN_EPISODES, seed=0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = check_launches(tag, runner, layers)
    finally:
        FT._fused_trajectory_train = loss_pass
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    agent = agents[-1]
    n_batches = TRAIN_EPISODES // TRAIN_BATCH
    losses = [float(x) for x in rec["losses"]]
    if len(losses) != n_batches or not all(
            math.isfinite(x) and 0 < x < MAX_LOSS for x in losses):
        raise RuntimeError(f"[{tag}] losses {losses}: not all finite and in "
                           f"(0, {MAX_LOSS})")
    norms = [float(n) for n in norms]
    if len(norms) != n_batches // args.gradient_accumulation_step or not all(
            math.isfinite(n) and n > 0 for n in norms):
        raise RuntimeError(f"[{tag}] global gradient norms {norms}")
    # the sampling pass took the cached step throughout: no uncached step,
    # no mid-batch bailout
    if runner.eval_steps or not runner.cached_steps \
            or not runner.prefill_calls or agent.dagger_bailouts:
        raise RuntimeError(f"[{tag}] the DAgger batches did not take the "
                           f"cached "
                           f"sampling step: {runner.eval_steps} uncached, "
                           f"{runner.cached_steps} cached steps, "
                           f"{runner.prefill_calls} prefills, "
                           f"{agent.dagger_bailouts} bailouts")
    bad = n_draws = 0
    for a_t, logits, active in rec["draws"]:
        act = torch.from_numpy(np.asarray(active)).to(logits.device)
        chosen = logits.gather(1, a_t.long()[:, None])[:, 0]
        bad += int(((chosen <= NEG_INF / 2) & act).sum())
        n_draws += int(act.sum())
    if bad:
        raise RuntimeError(f"[{tag}] {bad} sampled actions are not a valid "
                           f"candidate of their row")
    # the policy: every sampling step and prefill on the W8A8 copy (or on
    # the live weights), one copy per optimizer step of the run
    if rec["policy"][not sample_quant] or (
            sample_quant and runner.sampling_quantizations != len(norms)):
        raise RuntimeError(f"[{tag}] sampling calls by policy (W8A8: True) "
                           f"{rec['policy']}; {runner.sampling_quantizations} "
                           f"quantizations for {len(norms)} optimizer steps")
    groups = len({id(c[2]) for c in agent._dagger_cache_pool})
    cache_bytes = sum(runner.prefix_cache_bytes(b, p)
                      for b, p, _ in agent._dagger_cache_pool)
    steps = runner.cached_steps
    lp = rec["dagger_lp"]
    sample_s = [d - l for d, l in zip(rec["dagger_s"], lp)]
    quant_note = (f"W8A8 sampling policy: {rec['policy'][True]} sampling "
                  f"calls on it, {runner.sampling_quantizations} "
                  f"quantizations ({1e3 * runner.sampling_quant_s:.1f} ms in "
                  f"all) for {len(norms)} optimizer steps; "
                  if sample_quant else "")
    print(f"[{tag}] stage multi, {TRAIN_EPISODES} episodes in {dt:.3f} s = "
          f"{TRAIN_EPISODES / dt:.3f} episodes/s, {len(norms)} optimizer "
          f"steps; {quant_note}teacher batch "
          f"{[round(1e3 * x, 1) for x in rec['teacher_s']]} ms; DAgger "
          f"batch {[round(1e3 * x, 1) for x in rec['dagger_s']]} ms = "
          f"sampling {[round(1e3 * x, 1) for x in sample_s]} + loss pass "
          f"{[round(1e3 * x, 1) for x in lp]} ms; {steps} cached sampling "
          f"steps and {runner.prefill_calls} prefills in {groups} slot "
          f"groups, {rec['sample_tokens'] / steps:.1f} LLM tokens per "
          f"sampling step (prefills included), {n_draws} draws of active "
          f"rows, all valid; cache {cache_bytes} bytes "
          f"({cache_bytes / 2 ** 30:.3f} GiB); {runner.grad_calls} grad "
          f"calls; peak memory {peak:.2f} GiB; losses "
          f"{[round(x, 4) for x in losses]} (mean {avg_loss:.4f}); grad "
          f"norms {[round(n, 4) for n in norms]}; launches {launches}")
    del tx
    return launches, {"sample_ms": [1e3 * x for x in sample_s],
                      "loss_pass_ms": [1e3 * x for x in lp], "peak_gib": peak,
                      "quant_ms": 1e3 * runner.sampling_quant_s,
                      "quantizations": runner.sampling_quantizations,
                      "opt_steps": len(norms)}


def phase_sampler(bpe, cfg, model, tmp):
    """Phase 19: the sampler on the card (frequencies, masks, argmax at
    T -> 0, the override, the seed), then one DAgger batch with forced
    actions through cached and uncached sampling."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev)
    row = torch.tensor([[0.3, -1.2, 1.5, 0.0, 2.1, -0.4, NEG_INF, NEG_INF]],
                       device=dev)
    worst = 0.0
    for temperature in (1.0, 0.5):
        gen.manual_seed(7)
        draws = DM.sample_actions(row.expand(N_DRAWS, -1).contiguous(),
                                  temperature, gen)
        counts = torch.bincount(draws.long(), minlength=row.shape[1]).cpu()
        p = torch.softmax(row[0].cpu() / temperature, -1).double()
        sigma = (N_DRAWS * p * (1 - p)).sqrt()
        z = ((counts - N_DRAWS * p).abs()[:6] / sigma[:6]).max().item()
        worst = max(worst, z)
        if counts[6:].sum() or z > 5:
            raise RuntimeError(f"[19] T={temperature}: counts "
                               f"{counts.tolist()} against "
                               f"{(N_DRAWS * p).tolist()}")
    g2 = torch.Generator(device=dev).manual_seed(3)
    logits = torch.randn((N_DRAWS, 12), generator=g2, device=dev)
    logits[:, 5:] = NEG_INF
    for temperature in (1.0, 1e-6, 100.0):
        gen.manual_seed(2)
        if int(DM.sample_actions(logits, temperature, gen).max()) >= 5:
            raise RuntimeError(f"[19] T={temperature}: a masked candidate "
                               f"was drawn")
    gen.manual_seed(1)
    if not torch.equal(DM.sample_actions(logits, 1e-6, gen),
                       logits.argmax(-1).int()):
        raise RuntimeError("[19] T=1e-6 is not the argmax")
    override = torch.full((N_DRAWS,), -1, dtype=torch.int32, device=dev)
    override[::3] = 4
    a = DM.select_actions(logits, override, True, 1.0,
                          gen.manual_seed(11))
    b = DM.select_actions(logits, override, True, 1.0,
                          torch.Generator(device=dev).manual_seed(11))
    if not torch.equal(a, b) or not torch.equal(a[::3], override[::3]):
        raise RuntimeError("[19] the override or the seed does not hold")
    print(f"[19] sampler on the card: {N_DRAWS} draws at T in (1, 0.5) "
          f"within {worst:.2f} sigma of softmax(logits/T) per bin, no "
          f"masked candidate at T in (1, 1e-6, 100), T=1e-6 gives the "
          f"argmax, the override wins, a seed repeats its draws")

    # one DAgger batch sampled (cached), then its actions forced through
    # cached and uncached sampling: the same trajectories, permutations and
    # dropout, so the same loss pass inputs
    args, runner = dagger_setup(bpe, cfg, model)
    _, _, rollout = dagger_batch(tmp, args, runner)
    last = cfg.llm.num_layers - 1
    watch = {"llm.layers.wq[0]": lambda m: m.llm.layers.wq.grad[0],
             f"llm.layers.wq[{last}]": lambda m: m.llm.layers.wq.grad[last],
             "out_head.w": lambda m: m.out_head.w.grad,
             "pano.mapper.w": lambda m: m.pano.mapper.w.grad}
    groups, loss_pass = [], FT._fused_trajectory_train

    def capture(*a, **kw):
        groups.append(kw["steps"])
        return loss_pass(*a, **kw)

    def run(prefix_cache, forced=None):
        runner.rng.manual_seed(7)
        runner.zero_grads()
        lp = []
        FT._fused_trajectory_train = cuda_timed(capture, lp)
        try:
            loss, paths, t, counts = rollout(prefix_cache, forced)
        finally:
            FT._fused_trajectory_train = loss_pass
        grads = {k: f(model).float().clone() for k, f in watch.items()}
        return float(loss), paths, grads, t - sum(lp), sum(lp), counts

    sampled = run(True)
    n_steps = max(len(st) for st in groups)
    forced = [np.concatenate([st[t]["actions"] if t < len(st)
                              else np.zeros(len(st[0]["actions"]), np.int64)
                              for st in groups]) for t in range(n_steps)]
    with_cache = run(True, forced)
    without = run(False, forced)
    runner.take_grads()
    if not (sampled[1] == with_cache[1] == without[1]):
        raise RuntimeError("[19] the forced trajectories differ between "
                           "cached and uncached sampling")
    if with_cache[5][1] or not with_cache[5][0] or without[5][0] \
            or not without[5][1]:
        raise RuntimeError(f"[19] sampling steps (cached, uncached, "
                           f"prefills): {with_cache[5]} and {without[5]}")
    rel = abs(with_cache[0] - without[0]) / abs(without[0])
    cos = {k: torch.nn.functional.cosine_similarity(
        with_cache[2][k].flatten(), without[2][k].flatten(), dim=0).item()
        for k in watch}
    print(f"[19] one DAgger batch of {TRAIN_BATCH}, forced to the sampled "
          f"run's actions: trajectories equal ({n_steps} steps); loss "
          f"cached {with_cache[0]:.6f} uncached {without[0]:.6f} (rel "
          f"{rel:.3e}, limit {DAGGER_AB_LOSS_REL:.3e}); gradient cosine "
          f"{ {k: round(v, 6) for k, v in cos.items()} }; sampling "
          f"{1e3 * with_cache[3]:.1f} ms cached ({with_cache[5][0]} steps, "
          f"{with_cache[5][2]} prefills) against {1e3 * without[3]:.1f} ms "
          f"uncached ({without[5][1]} steps); loss pass "
          f"{1e3 * with_cache[4]:.1f} and {1e3 * without[4]:.1f} ms")
    if not rel <= DAGGER_AB_LOSS_REL or min(cos.values()) < MIN_GRAD_COSINE:
        raise RuntimeError("[19] the forced batch's loss pass differs "
                           "between cached and uncached sampling")


def dagger_batch(tmp, args, runner):
    """One DAgger batch of TRAIN_BATCH on its own world, with candidates in
    graph order. Returns (agent, dataset, rollout): rollout(prefix_cache,
    forced=None, **flags) runs it through rollout_dagger_fused (flags:
    TrainArgs fields) and returns (loss, paths, wall s, (cached steps,
    uncached steps, prefills))."""
    anno = T.make_r2r_world(f"{tmp}/ab", n_episodes=TRAIN_BATCH, seed=3,
                            split="train")
    agent, ds, _ = T.r2r_train(anno, runner, args, TRAIN_BATCH)
    optim = T.train_config(MAX_ACTION_LEN).Optim

    def rollout(prefix_cache, forced=None, **flags):
        a2 = dataclasses.replace(args, dagger_prefix_cache=prefix_cache,
                                 **flags)
        batch = next(iter(Dataloader(ds, TRAIN_BATCH, shuffle=False)))
        zero_counters(runner)
        t = []
        loss, traj = cuda_timed(FT.rollout_dagger_fused, t)(
            agent, a2, "R2R", optim, batch, dataset=ds, train_ml=1.0,
            forced_actions=forced, np_rng=IdentityPermutation())
        return (loss, [x["path"] for x in traj], t[0],
                (runner.cached_steps, runner.eval_steps, runner.prefill_calls))
    return agent, ds, rollout


def phase_sampled_ab(bpe, cfg, model, tmp):
    """Phase 15, continued: one DAgger batch sampled through uncached and
    through cached sampling on the same noise per (slot group, step)
    (sampling_probe), its per-step logits and draws held against each
    other (sampled_ab), on the weights phase 15's snapshot sees; the cached
    run with the last cached token of every row hidden must fail."""
    args, runner = dagger_setup(bpe, cfg, model)
    agent, _, rollout = dagger_batch(tmp, args, runner)
    temperature = max(float(args.temperature), 1e-6)
    with sampling_probe(runner) as probe:
        ref = probe.run(lambda: rollout(False))
        got = probe.run(lambda: rollout(True))
    if ref["out"][3][0] or not ref["out"][3][1] or got["out"][3][1] \
            or not got["out"][3][0] or agent.dagger_bailouts:
        raise RuntimeError(f"[15] sampling steps (cached, uncached, "
                           f"prefills): {ref['out'][3]} and {got['out'][3]}, "
                           f"{agent.dagger_bailouts} bailouts")
    fails, st = sampled_ab(ref, got, temperature)
    f_fails, f_st = sampled_ab(ref, got["fault"], temperature)
    print(f"[15] one DAgger batch of {TRAIN_BATCH} sampled (T="
          f"{temperature:g}) through uncached and cached sampling on the "
          f"same noise per (slot group, step): {st['rows']} of "
          f"{st['ref_rows']} active draws compared over {st['steps']} "
          f"steps, {st['decisive']} with a Gumbel-max margin above the "
          f"logit limit; {st['diverged']} rows parted on a draw within the "
          f"limit; logits within {st['worst']:.3f} of the per-element "
          f"limit; {len(fails)} steps fail. The cached run with the last "
          f"cached token of every row hidden: {len(f_fails)} of "
          f"{f_st['steps']} steps fail (worst finite excess "
          f"{f_st['worst']:.3f}; {f_fails[:3]})")
    if not f_fails:
        raise RuntimeError("[15] the sampled A/B passes a planted fault (the "
                           "last cached token hidden)")
    if fails or st["rows"] * 2 < st["ref_rows"] or not st["decisive"]:
        raise RuntimeError(f"[15] cached sampling differs from uncached: "
                           f"{fails[:4] or st}")


class IdentityPermutation:
    """np_rng for the DAgger A/B: candidates in graph order, so that a
    row's prompt does not depend on how many draws the other rows took."""

    def permutation(self, x):
        return np.asarray(x)


class sampling_probe(contextlib.AbstractContextManager):
    """Runs the fused DAgger with every draw keyed by (slot group, step)
    instead of the call order: the group's generator is driven through a
    wrapper that sets the key before each step, and the step's generator
    is seeded from it. Two runs then draw the same noise for the same step
    of the same group, even where a row's diverging trajectory changes how
    the groups interleave. Records per key the f32 logits, the Gumbel noise
    (replayed from the same seed), the draws and the active rows; a cached
    step is also run on copies with the last cached token of every row
    hidden, recorded apart as the planted fault."""

    def __init__(self, runner):
        self.runner = runner
        self.key = None

    def seed(self):
        return 1_000_003 * (self.key[0] + 1) + self.key[1]

    def __enter__(self):
        r = self.runner
        self.saved = (FT._dagger_sample_group, DM.sample_actions,
                      FT._fused_trajectory_train, r.eval_step,
                      r.eval_step_cached)
        group, sample, _, step, cached = self.saved
        probe = self

        def labelled(*a, **kw):
            g = probe.groups
            probe.groups += 1
            return drive(group(*a, **kw), g)

        def drive(inner, g):
            k = 0
            while True:
                probe.key = (g, k)
                try:
                    next(inner)
                except StopIteration:
                    return
                k += 1
                yield

        def sampling(do_sample, temperature):
            gen = torch.Generator(device=r.device).manual_seed(
                probe.seed()) if do_sample else None
            return {"do_sample": do_sample,
                    "temperature": float(temperature), "generator": gen}

        def recording_sample(logits, temperature, generator):
            a_t = sample(logits, temperature, generator)
            replay = torch.Generator(device=logits.device).manual_seed(
                probe.seed())
            u = torch.rand(logits.shape, generator=replay,
                           device=logits.device, dtype=torch.float32)
            u = u.clamp_(min=torch.finfo(torch.float32).tiny)
            probe.rec[probe.key] = {"logits": logits.float().clone(),
                                    "noise": -torch.log(-torch.log(u)),
                                    "draws": a_t.long().clone()}
            return a_t

        def no_loss_pass(agent, args, **kw):
            probe.steps.append(kw["steps"])
            return torch.zeros((), device=r.device), kw["traj"]

        def uncached_step(*a, **kw):
            probe.active[probe.key] = np.asarray(kw["active_mask"]).copy()
            return step(*a, **kw)

        def cached_step(state, cache, *a, **kw):
            probe.active[probe.key] = np.asarray(kw["active_mask"]).copy()
            hidden = {k: v.clone() for k, v in cache.items()}
            hidden["plen"] = (hidden["plen"] - 1).clamp_(min=0)
            probe.rec = probe.out_fault
            cached({k: v.clone() for k, v in state.items()}, hidden, *a,
                   **kw)
            probe.rec = probe.out_good
            return cached(state, cache, *a, **kw)

        FT._dagger_sample_group = labelled
        DM.sample_actions = recording_sample
        FT._fused_trajectory_train = no_loss_pass
        r._sampling = sampling
        r.eval_step = uncached_step
        r.eval_step_cached = cached_step
        return self

    def run(self, fn):
        """fn() under the probe: {"out": fn's result, "rec" and "active":
        this run's records, "steps": the slot groups' step snapshots,
        "fault": the planted fault's records (cached steps only)}."""
        self.groups = 0
        self.active, self.out_good, self.out_fault, self.steps = {}, {}, {}, []
        self.rec = self.out_good
        out = fn()
        return {"out": out, "rec": self.out_good, "active": self.active,
                "steps": self.steps,
                "fault": {"rec": self.out_fault, "active": self.active}}

    def __exit__(self, *exc):
        r = self.runner
        (FT._dagger_sample_group, DM.sample_actions,
         FT._fused_trajectory_train, r.eval_step, r.eval_step_cached) = \
            self.saved
        del r._sampling
        return False


def sampled_ab(ref, got, temperature):
    """Holds one sampled DAgger run (got) against another on the same noise
    (ref), key by key (slot group, step), over the rows active in both
    whose trajectories have not parted: the candidate logits per element
    within phase 15's limit (logit_tol), and the same draw wherever ref's
    Gumbel-max margin exceeds what that limit lets move it (the winner's
    score minus its tolerance above every other's plus theirs). A row that
    draws otherwise within its margin has parted and leaves the comparison.
    Returns (one line per step that breaks this, counts)."""
    parted, fails = set(), []
    st = {"steps": 0, "rows": 0, "decisive": 0, "diverged": 0, "worst": 0.0,
          "ref_rows": sum(int(a.sum()) for a in ref["active"].values())}
    for key in sorted(set(ref["active"]) | set(got["active"])):
        g = key[0]
        a_ref, a_got = ref["active"].get(key), got["active"].get(key)
        if a_ref is None or a_got is None:
            only = a_ref if a_got is None else a_got
            if any((g, i) not in parted for i in np.nonzero(only)[0]):
                fails.append(f"step {key} ran in one run only")
            continue
        live = [i for i in range(len(a_ref))
                if (g, i) not in parted and (a_ref[i] or a_got[i])]
        if any(a_ref[i] != a_got[i] for i in live):
            fails.append(f"step {key}: rows ended apart")
            continue
        if not live:
            continue
        st["steps"] += 1
        r, o = ref["rec"].get(key), got["rec"].get(key)
        if r is None or o is None:
            fails.append(f"step {key}: no draw in one run")
            continue
        if not torch.equal(r["noise"], o["noise"]):
            fails.append(f"step {key}: the noise differs")
            continue
        idx = torch.tensor(live, device=r["logits"].device)
        want, have = r["logits"][idx], o["logits"][idx]
        if not torch.isfinite(have).all():
            fails.append(f"step {key}: logits not finite")
            continue
        excess = cached_logit_excess(have, want)
        if math.isfinite(excess):
            st["worst"] = max(st["worst"], excess)
        if not excess <= 1:
            fails.append(f"step {key}: logits at {excess:.3f} of the limit")
            continue
        score = want / temperature + r["noise"][idx]
        top = score.argmax(-1)
        if not torch.equal(top, r["draws"][idx]):
            fails.append(f"step {key}: the replayed noise misses the draw")
            continue
        slack = cached_logit_tol(want)[0] / temperature
        hi = (score - slack).gather(1, top[:, None])[:, 0]
        rest = (score + slack).scatter(1, top[:, None], -math.inf)
        decisive = (hi > rest.max(-1).values).tolist()
        same = (r["draws"][idx] == o["draws"][idx]).tolist()
        for j, i in enumerate(live):
            st["rows"] += 1
            st["decisive"] += decisive[j]
            if decisive[j] and not same[j]:
                fails.append(f"step {key} row {i}: a decisive draw differs")
            elif not same[j]:
                parted.add((g, i))
                st["diverged"] += 1
    return fails, st


def phase_run_training(bpe, cfg, model, tmp):
    """Phase 20: run_training at stage multi on the 7B-width runner from a
    YAML text the port's reader parses: one epoch of 4 batches of 8 (2
    teacher, 2 DAgger), streaming validation of RUN_VAL_EPISODES episodes,
    max_saved_checkpoints=1, so epoch_0 is written in the torch backend;
    then restored into a freshly drawn model and compared bit for bit.
    Returns the run's kernel launches."""
    root = f"{tmp}/run"
    T.make_r2r_world(root, n_episodes=TRAIN_EPISODES, seed=4, split="train")
    T.make_r2r_world(root, n_episodes=RUN_VAL_EPISODES, seed=5, split="val")
    ycfg = load_yaml_text(run_yaml("{image_feat_size: 1024, "
                                   "angle_feat_size: 4}"))
    args = TrainArgs(data_dir=root, output_dir=f"{root}/out", stage="multi",
                     num_epochs=1, num_steps_per_epoch=4,
                     batch_size=TRAIN_BATCH, val_batch_size=N_SLOTS,
                     gradient_accumulation_step=2,
                     fused_rows_per_call=ROWS_PER_CALL,
                     max_saved_checkpoints=1, seed=0)
    args.sync_from_config(ycfg)
    runner = NavModelRunner(cfg, model, bpe, dims=DAGGER_DIMS,
                            feat_dropout=args.feat_dropout, seed=args.seed)
    saves = []
    orig_save = TTL.save_checkpoint
    free_before = shutil.disk_usage(tmp).free
    TTL.save_checkpoint = cuda_timed(orig_save, saves)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(runner)
    try:
        t0 = time.perf_counter()
        res = TTL.run_training(args, ycfg, feat_dbs={
            "mp3d": SyntheticImageFeaturesDB(cfg.pano.image_feat_size)},
            runner=runner)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        TTL.save_checkpoint = orig_save
    launches = check_launches(20, runner, cfg.llm.num_layers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    r2r = res["R2R"]
    if not all(math.isfinite(r2r[k]) for k in ("sr", "spl")):
        raise RuntimeError(f"[20] SR/SPL not finite: {r2r}")
    ck = Path(args.output_dir) / "epoch_0"
    header = json.loads(ck.with_suffix(".json").read_text())
    if header.get("backend") != "torch" or len(saves) != 1 \
            or not ck.with_suffix(".pt").exists():
        raise RuntimeError(f"[20] expected one torch-backend checkpoint: "
                           f"{header}, {len(saves)} saves")
    nbytes = ck.with_suffix(".pt").stat().st_size
    free_after = shutil.disk_usage(tmp).free
    # restore into a model drawn from another seed, on the card
    for p in model.parameters():
        p.grad = None
    gc.collect()
    torch.cuda.empty_cache()
    dev = next(model.parameters()).device
    fresh = NavModel(cfg, init_nav_params(
        cfg, torch.Generator(device=dev).manual_seed(1), device=dev))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    load_checkpoint(ck, fresh)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t1
    differ = [n for (n, a), b in zip(model.named_parameters(),
                                     fresh.parameters())
              if a.dtype != b.dtype or not torch.equal(a, b)]
    del fresh
    ck.with_suffix(".pt").unlink()
    gc.collect()
    torch.cuda.empty_cache()
    if differ:
        raise RuntimeError(f"[20] the restored checkpoint differs from the "
                           f"model in {len(differ)} tensors: {differ[:4]}")
    print(f"[20] run_training (stage multi, 1 epoch of 4 batches of "
          f"{TRAIN_BATCH}, validation of {RUN_VAL_EPISODES} episodes) in "
          f"{dt:.3f} s: R2R {({k: round(float(v), 2) for k, v in r2r.items()})}"
          f"; {runner.grad_calls} grad calls, {runner.cached_steps} cached "
          f"sampling steps, {runner.prefill_calls} prefills, "
          f"{runner.eval_steps} uncached (validation) steps; peak memory "
          f"{peak:.2f} GiB; launches {launches}; checkpoint epoch_0 "
          f"(torch backend, bf16 kept): {nbytes} bytes "
          f"({nbytes / 2 ** 30:.3f} GiB) written in {saves[0]:.2f} s, read "
          f"into a fresh model in {read_s:.2f} s, every tensor bit for bit "
          f"equal; free disk {free_before / 2 ** 30:.1f} GiB before, "
          f"{free_after / 2 ** 30:.1f} GiB with the checkpoint")
    return launches


def cli_main(argv, losses=None, feature_files: bool = False):
    """The entry point's main(argv) on the card, its runner, epoch result
    and trained tasks recorded (and each batch's loss appended to
    ``losses``, a list, when given); the YAML's object_database resolves to
    synthetic stores where run_training builds them (the card's machine
    has no lmdb), and so does its feature_database unless
    ``feature_files``: then create_feature_db is left as it is and reads
    the YAML's HDF5 files (phase 50). Returns (results, runner, (average
    loss, gradient norms), tasks trained, seconds)."""
    from navillm_tpu_torch.agents.llava_agent import LLaVAAgent
    built, epochs, names = [], [], []
    saved = (TTL.build_runner, TTL.create_feature_db,
             TTL.create_object_feature_db, TTL.train_one_epoch,
             R2RAgent.train, LLaVAAgent.train)

    def build_runner(*a, **kw):
        built.append(saved[0](*a, **kw))
        return built[-1]

    def feature_dbs(config, image_feat_size, data_dir):
        return {src: T.feature_dbs(image_feat_size)[src] for src in config}

    def object_dbs(config, obj_feat_size, data_dir):
        return {src: synthetic_object_db(src, obj_feat_size, OG_OBJECTS)
                for src in config}

    def train_one_epoch(*a, **kw):
        epochs.append(saved[3](*a, **kw))
        return epochs[-1]

    def named(fn):
        def train(self, name, *a, **kw):
            names.append(name)
            loss = fn(self, name, *a, **kw)
            if losses is not None:
                losses.append(loss)
            return loss
        return train

    for fn in COUNTERS.values():
        fn.launches = 0
    TTL.build_runner, TTL.create_feature_db, TTL.create_object_feature_db, \
        TTL.train_one_epoch, R2RAgent.train, LLaVAAgent.train = \
        build_runner, saved[1] if feature_files else feature_dbs, \
        object_dbs, train_one_epoch, named(saved[4]), named(saved[5])
    try:
        t0 = time.perf_counter()
        res = TRAIN.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        TTL.build_runner, TTL.create_feature_db, \
            TTL.create_object_feature_db, TTL.train_one_epoch, \
            R2RAgent.train, LLaVAAgent.train = saved
    return res, built[0], epochs[0] if epochs else None, names, dt


def phase_cli(tmp, ref=None):
    """Phase 21: the entry point's main() (python -m navillm_tpu_torch.train)
    on its defaults: the card, stage multi, the JAX DAgger defaults, no
    pretrained path, so build_runner's model (2 layers, hidden 256 over 4
    heads of 64, bf16: what the attention kernels take) with random
    weights from --seed. 1 epoch of 4 batches of CLI_BATCH (2 teacher, 2
    DAgger), streaming validation, max_saved_checkpoints=1 (an npz
    checkpoint). The YAML's feature_database resolves to
    SyntheticImageFeaturesDB where run_training builds it.

    With ``ref`` (phase 21's result), phase 50 (c): the same run, but the
    world's views are first written to the YAML's feature_database
    (features.hdf5, SyntheticImageFeaturesDB's values) by
    testing.write_hdf5_features and run_training reads them through an
    unpatched create_feature_db and the port's HDF5 reader; its losses,
    gradient norms, metrics and launches must be phase 21's. Returns (the
    run's kernel launches, its loss, norms and R2R metrics)."""
    tag = 21 if ref is None else 50
    root = f"{tmp}/cli"
    T.make_r2r_world(root, n_episodes=4 * CLI_BATCH, seed=6, split="train")
    T.make_r2r_world(root, n_episodes=CLI_VAL_EPISODES, seed=7, split="val")
    yaml_path = Path(root) / "r2r.yaml"
    yaml_path.write_text(run_yaml('{image_feat_size: 32, angle_feat_size: '
                                  '4, feature_database: {"mp3d": '
                                  '"features.hdf5"}}'))
    features = Path(root) / "features.hdf5"
    opened = []
    if ref is not None:
        T.write_hdf5_features(features, f"{root}/connectivity", 32)
    out = Path(root) / "out"
    with hdf5_opens(opened):
        res, runner, (avg_loss, norms), _, dt = cli_main([
            "--cfg_file", str(yaml_path), "--data_dir", root,
            "--output_dir", str(out), "--num_epochs", "1",
            "--num_steps_per_epoch", "4", "--batch_size", str(CLI_BATCH),
            "--val_batch_size", str(N_SLOTS), "--max_saved_checkpoints",
            "1"], feature_files=ref is not None)
    llm = runner.cfg.llm
    if runner.device.type != "cuda" or llm.dtype != torch.bfloat16 \
            or llm.head_dim not in (64, 128):
        raise RuntimeError(f"[{tag}] build_runner built {llm} on "
                           f"{runner.device}")
    launches = check_launches(tag, runner, llm.num_layers)
    if not (runner.grad_calls and runner.cached_steps and runner.eval_steps):
        raise RuntimeError(f"[{tag}] {runner.grad_calls} grad calls, "
                           f"{runner.cached_steps} cached sampling steps, "
                           f"{runner.eval_steps} validation steps")
    norms = [float(n) for n in norms]
    if not (math.isfinite(avg_loss) and 0 < avg_loss < MAX_LOSS) or \
            len(norms) != 2 or not all(math.isfinite(n) and n > 0
                                       for n in norms):
        raise RuntimeError(f"[{tag}] loss {avg_loss}, gradient norms "
                           f"{norms}")
    r2r = res["R2R"]
    if not all(math.isfinite(r2r[k]) for k in ("sr", "spl")):
        raise RuntimeError(f"[{tag}] SR/SPL not finite: {r2r}")
    header = json.loads((out / "epoch_0.json").read_text())
    # train.log: the process's first main() only (its logger is made once
    # per process, as in JAX)
    if header.get("backend") != "npz" or not (out / "epoch_0.npz").exists() \
            or (ref is None and not (out / "train.log").exists()):
        raise RuntimeError(f"[{tag}] expected epoch_0.npz and train.log in "
                           f"{sorted(p.name for p in out.iterdir())}")
    result = {"loss": float(avg_loss), "norms": norms,
              "r2r": {k: float(v) for k, v in r2r.items()}}
    n = sum(p.numel() for p in runner.model.parameters())
    print(f"[{tag}] python -m navillm_tpu_torch.train's main() on its "
          f"defaults (the card, stage multi): {n / 1e6:.2f} M params "
          f"({llm.num_layers} layers, {llm.num_heads} heads of "
          f"{llm.head_dim}, bf16) in {dt:.3f} s: loss {avg_loss:.4f}, grad "
          f"norms {[round(x, 4) for x in norms]}; R2R "
          f"{({k: round(v, 2) for k, v in result['r2r'].items()})}; "
          f"{runner.grad_calls} grad calls, {runner.cached_steps} cached "
          f"sampling steps, {runner.prefill_calls} prefills, "
          f"{runner.eval_steps} validation steps; launches {launches}; "
          f"epoch_0.npz {(out / 'epoch_0.npz').stat().st_size} bytes")
    if ref is None:
        if opened:
            raise RuntimeError(f"[21] HDF5 files opened: {opened}")
        return launches, result
    if not opened or set(opened) != {str(features)}:
        raise RuntimeError(f"[50] the HDF5 files the run opened: {opened}, "
                           f"not {features}")
    if launches != ref["launches"] or any(
            result[k] != ref[k] for k in ("loss", "norms", "r2r")):
        raise RuntimeError(f"[50] over the HDF5 file: launches {launches}, "
                           f"{result}; phase 21 over the synthetic store: "
                           f"{ref}")
    print(f"[50] the entry point over its feature_database "
          f"({features.stat().st_size} bytes, opened {len(opened)} time(s) "
          f"by the port's reader, create_feature_db unpatched): loss, "
          f"gradient norms, "
          f"R2R metrics and launches equal to phase 21's bit for bit")
    return launches, result


@contextlib.contextmanager
def hdf5_opens(sink):
    """Appends to ``sink`` the path of every HDF5 file the port opens for
    reading inside the block."""
    init = hdf5.FileReader.__init__

    def recorded(self, path):
        sink.append(os.fspath(path))
        init(self, path)

    hdf5.FileReader.__init__ = recorded
    try:
        yield sink
    finally:
        hdf5.FileReader.__init__ = init


def gen_inputs(bpe, cfg, model, tmp):
    """Phase 22's prompts: the first observations of N_SLOTS EQA episodes as
    the EQA head assembles them (the 12 horizon views at its <cand> tokens,
    the question), with GEN_AB_HISTORY history embeds (panorama embeds of
    the views). Returns (runner, input_ids, attention_mask, inject
    positions, inject embeds on the card)."""
    root = f"{tmp}/gen_ab"
    T.make_r2r_world(root, n_episodes=N_SLOTS, seed=11)
    runner = NavModelRunner(cfg, model, bpe, dims=slice_dims())
    agent, ds, _ = T.eqa_eval(root, "val", runner, N_SLOTS,
                              cfg.pano.image_feat_size)
    obs = [ds[i]["observations"] for i in range(N_SLOTS)]
    pano_in, nav_mask, toks, cand_pos, hist_pos = agent._generation_inputs(
        obs, [["<hist>"] * n for n in GEN_AB_HISTORY],
        [ob["instruction"] for ob in obs], "embodied_qa")
    pe = runner.panorama_dev_dict(pano_in, deterministic=True)["pano_embeds"]
    hist = agent.hist_arrays([list(pe[i, :n].float().cpu().numpy())
                              for i, n in enumerate(GEN_AB_HISTORY)])
    emb = runner.gen_embeds(pe, nav_mask)[:, : cand_pos.shape[1]]
    return (runner, toks.input_ids, toks.attention_mask,
            np.concatenate([cand_pos, hist_pos], 1),
            torch.cat([emb.float(), runner.upload(hist)], 1))


def device_events(fn) -> int:
    """Device events (kernels, copies, memsets) of one call of fn, from
    torch.profiler; 0 if the trace holds none."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for e in prof.events() if e.device_type == cuda)


def phase_gen_ab(bpe, cfg, model, tmp):
    """Phase 22: generate's prefill through K1 against the eager attention
    on EQA prompts (left-padded to the 64 bucket, so the leading pad rows
    see no key): every row of the prefill finite, the last position's
    logits per element within the CACHED_LOGIT_* bound (logit_tol); the
    greedy tokens of both equal on every step whose top-2 margin exceeds
    that bound; decode_step's hidden at step 0 against forward_hidden over
    the prompt and the token, within the same bound. Times the prefill and
    the decode steps. Returns the measures."""
    runner, ids, mask, inj_pos, inj_emb = gen_inputs(bpe, cfg, model, tmp)
    llm, smask, layers = model["llm"], runner.special_mask, cfg.llm.num_layers
    eager = dataclasses.replace(cfg.llm, attn_impl="eager")
    b_ids, b_mask, b_pos = D.bucket_prompt(ids, mask, inj_pos, bpe.pad_id)
    dev_ids, dev_mask, dev_pos = (runner.upload(x) for x in (
        b_ids.astype(np.int64), b_mask, b_pos))
    out = {}
    flash_attention_fwd.launches = 0
    with torch.inference_mode():
        for name, c in (("kernel", cfg.llm), ("eager", eager)):
            x = L.embed_with_injection(llm, dev_ids, dev_pos, inj_emb)
            hidden, kv = L.forward_hidden(llm, c, x, dev_mask, return_kv=True)
            out[name] = (hidden, kv, L.logits_from_hidden(
                llm, c, hidden[:, -1], smask))
    if flash_attention_fwd.launches != layers:
        raise RuntimeError(f"[22] {flash_attention_fwd.launches} K1 launches "
                           f"in the prefill, not {layers}")
    hk, kvk, lk = out["kernel"]
    bad = [n for n, t in (("hidden", hk), ("K", kvk["k"]), ("V", kvk["v"]))
           if not torch.isfinite(t).all()]
    if bad:
        raise RuntimeError(f"[22] the kernel prefill's {bad} are not finite "
                           f"on every row")
    pad_rows = int((~dev_mask).sum())
    prefill_exc = logit_excess(lk, out["eager"][2])
    if not prefill_exc <= 1:
        raise RuntimeError(f"[22] prefill logits kernel vs eager at "
                           f"{prefill_exc:.3f} of the limit")

    # the greedy tokens, each pick's logits recorded
    pick, picks = D.pick_token, []

    def recording_pick(logits, *a, **kw):
        picks[-1].append(logits.float().masked_fill(smask, NEG_INF))
        return pick(logits, *a, **kw)
    D.pick_token = recording_pick
    try:
        toks = {}
        for name, c in (("kernel", cfg.llm), ("eager", eager)):
            picks.append([])
            toks[name] = D.generate(
                llm, c, ids, mask, inject_positions=inj_pos,
                inject_embeds=inj_emb, special_token_mask=smask,
                eos_id=bpe.eos_id, pad_id=bpe.pad_id,
                max_new_tokens=GEN_AB_TOKENS).cpu().numpy()
    finally:
        D.pick_token = pick
    tk, te = toks["kernel"], toks["eager"]
    parted, compared, worst = [], 0, 0.0
    for i in range(N_SLOTS):
        for k in range(min(len(picks[0]), len(picks[1]))):
            want = picks[1][k][i:i + 1]
            if tk[i, k] == te[i, k]:
                compared += 1
                worst = max(worst, logit_excess(picks[0][k][i:i + 1], want))
                if te[i, k] == bpe.eos_id:
                    break
                continue
            tol, _ = logit_tol(want)
            top = want[0].topk(2)
            margin = (top.values[0] - top.values[1]).item()
            limit = tol[0, top.indices].sum().item()
            if margin > limit:
                raise RuntimeError(f"[22] row {i} parts at token {k} on a "
                                   f"top-2 margin {margin:.4f} above the "
                                   f"limit {limit:.4f}")
            parted.append((i, k, round(margin, 5), round(limit, 5)))
            break

    # decode_step's hidden at step 0 against the full forward
    with torch.inference_mode():
        tok0 = lk.argmax(-1)
        dec = L.init_decode_cache(cfg.llm, N_SLOTS, 1, runner.device)
        emb0 = L.embed_rows(llm["embed"], tok0)[:, None]
        lens = dev_mask.sum(-1)[:, None]
        hd, _ = L.decode_step(llm, cfg.llm, emb0, kvk, dev_mask, dec, 0, lens)
        full = L.embed_with_injection(
            llm, torch.cat([dev_ids, tok0[:, None]], 1), dev_pos, inj_emb)
        hf = L.forward_hidden(llm, cfg.llm, full, torch.cat(
            [dev_mask, dev_mask.new_ones((N_SLOTS, 1))], 1))[:, -1]
        hidden_exc = logit_excess(hd[:, 0].float(), hf.float())
        if not hidden_exc <= 1:
            raise RuntimeError(f"[22] decode_step's hidden vs forward_hidden "
                               f"at {hidden_exc:.3f} of the limit")
        prefill_ms = cuda_ms(lambda: D.prefill(llm, cfg.llm, dev_ids,
                                               dev_mask, dev_pos, inj_emb),
                             iters=5)
        events = device_events(lambda: L.decode_step(
            llm, cfg.llm, emb0, kvk, dev_mask, dec, 0, lens))
    steps, decode_step = [0], L.decode_step

    def counted(*a, **kw):
        steps[0] += 1
        return decode_step(*a, **kw)
    L.decode_step = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        D.generate(llm, cfg.llm, ids, mask, inject_positions=inj_pos,
                   inject_embeds=inj_emb, special_token_mask=smask,
                   eos_id=bpe.eos_id, pad_id=bpe.pad_id,
                   max_new_tokens=GEN_AB_TOKENS)
        torch.cuda.synchronize()
        gen_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        L.decode_step = decode_step
    decode_ms = (gen_ms - prefill_ms) / max(steps[0], 1)
    print(f"[22] generate A/B on {N_SLOTS} EQA prompts of {mask.shape[1]} "
          f"tokens (bucketed to {b_ids.shape[1]}; {pad_rows} of "
          f"{b_mask.size} rows are padding, every row of the kernel prefill "
          f"finite): prefill logits K1 vs eager attention at "
          f"{prefill_exc:.3f} of the limit; {compared} greedy tokens equal "
          f"before parting (worst logits there at {worst:.3f} of the limit),"
          f" rows parting (row, token, top-2 margin, limit): "
          f"{parted or 'none'}; decode_step's hidden at step 0 vs "
          f"forward_hidden over prompt + token at {hidden_exc:.3f} of the "
          f"limit; prefill {prefill_ms:.2f} ms, {GEN_AB_TOKENS} tokens in "
          f"{gen_ms:.1f} ms = {decode_ms:.2f} ms per decode token ({steps[0]}"
          f" decode steps); {events or 'not measured:'} device events per "
          f"decode step{'' if events else ' the trace holds none'}")
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "events": events}


def phase_eqa(tag, bpe, cfg, model, tmp, prefix_cache=False,
              warm_up=True, kv_int8=False, n_episodes=GEN_EPISODES):
    """Phases 23 and 25: EQA streaming evaluation of n_episodes episodes
    (2 slot groups of N_SLOTS, val_max_action_len GEN_MAX_ACTION_LEN, the
    answer vocabulary's trie), after a warm-up on its own world. Gates:
    every episode answered by its pass and its oracle pass, every answer in
    the vocabulary, K1 once per layer of every generate call (its prefill),
    uncached step and prefill call (and on an int4 tree K4 7 times per layer
    of every LLM pass: those and each decode step). kv_int8: generate keeps
    the prompt K/V int8. Returns the measures."""
    runner = NavModelRunner(cfg, model, bpe, dims=slice_dims(),
                            kv_int8=kv_int8)
    layers, feat = cfg.llm.num_layers, cfg.pano.image_feat_size
    gen_s, prefill_s, decodes = [], [], [0]
    runner.generate = cuda_timed(runner.generate, gen_s)
    prefill, decode_step = D.prefill, L.decode_step

    def counted_decode(*a, **kw):
        decodes[0] += 1
        return decode_step(*a, **kw)

    def run(root, n, seed):
        T.make_r2r_world(root, n_episodes=n, seed=seed)
        agent, ds, args = T.eqa_eval(root, "val", runner, N_SLOTS, feat,
                                     prefix_cache=prefix_cache)
        with torch.inference_mode():
            return agent.validate_streaming(
                "EQA", args, T.eval_config(GEN_MAX_ACTION_LEN, "EQA"),
                Dataloader(ds, N_SLOTS, shuffle=False), dataset=ds), ds

    D.prefill, L.decode_step = cuda_timed(prefill, prefill_s), counted_decode
    try:
        if warm_up:
            run(f"{tmp}/warm", 2 * N_SLOTS, 1)
        for v in (gen_s, prefill_s):
            v.clear()
        decodes[0] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counters(runner)
        t0 = time.perf_counter()
        preds, ds = run(f"{tmp}/main", n_episodes, 0)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        D.prefill, L.decode_step = prefill, decode_step
    launches = check_launches(tag, runner, layers)
    passes = (runner.eval_steps + runner.cached_steps + runner.prefill_calls
              + runner.generate_calls + decodes[0])
    check_q4(tag, runner, layers, decodes=decodes[0])
    if prefix_cache and (runner.eval_steps or not runner.cached_steps
                         or not runner.prefill_calls):
        raise RuntimeError(f"[{tag}] the cached run did not take the cached "
                           f"path: {runner.eval_steps} uncached steps")
    vocab = set(ds.answer_vocab)
    off = [p["instr_id"] for p in preds if p["pred_answer"] not in vocab
           or p["oracle_pred_answer"] not in vocab]
    if len(preds) != len(ds) or off:
        raise RuntimeError(f"[{tag}] {len(preds)} predictions for {len(ds)} "
                           f"episodes; answers outside the vocabulary: {off}")
    for p in preds:
        if p["trajectory"][0][0] != ds.gt_trajs[p["instr_id"]][1][0]:
            raise RuntimeError(f"[{tag}] {p['instr_id']} does not start at "
                               f"its start")
    avg, _ = ds.eval_metrics(preds, None, "EQA")
    if not all(math.isfinite(avg[k]) for k in ("sr", "spl", "exact_match")):
        raise RuntimeError(f"[{tag}] metrics not finite: {avg}")
    steps = runner.eval_steps + runner.cached_steps
    gen_total = sum(gen_s)
    st = {"ms_per_step": 1e3 * (dt - gen_total) / steps,
          "generate_calls": runner.generate_calls,
          "ms_per_generate": 1e3 * gen_total / len(gen_s),
          "ms_per_decode": 1e3 * (gen_total - sum(prefill_s))
          / max(decodes[0], 1),
          "decode_steps": decodes[0], "episodes_per_s": len(preds) / dt,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches, "q4_launches": matmul_q4.launches}
    kind = "cached" if prefix_cache else "uncached"
    q4_note = (f", int4 {matmul_q4.launches} = {passes} LLM passes x "
               f"{layers} x {Q4_LAYER_MATMULS}" if matmul_q4.launches else "")
    kv_note = ", int8 prompt K/V" if kv_int8 else ""
    print(f"[{tag}] EQA streaming eval ({kind}{kv_note}) of {len(preds)} episodes, "
          f"each with its oracle pass, in {dt:.3f} s = "
          f"{st['episodes_per_s']:.3f} episodes/s: {steps} {kind} steps at "
          f"{st['ms_per_step']:.2f} ms wall per step (generation excluded)"
          f"{f', {runner.prefill_calls} prefills' if prefix_cache else ''};"
          f" {st['generate_calls']} generate calls at "
          f"{st['ms_per_generate']:.1f} ms each ({st['decode_steps']} decode "
          f"steps, {st['ms_per_decode']:.2f} ms per decode token); exact "
          f"match {avg['exact_match']:.2f}, oracle "
          f"{avg['oracle_exact_match']:.2f}, SR {avg['sr']:.2f}; every answer "
          f"in the {len(vocab)}-word vocabulary; peak memory "
          f"{st['peak_gib']:.2f} GiB; launches {launches}{q4_note}")
    return st


def phase_run_gen(bpe, cfg, model, tmp):
    """Phase 24: run_training at stage multi with --enable_summarize
    --enable_fgr2r and --test_datasets R2R EQA on the 7B-width runner: one
    epoch of 4 batches of TRAIN_BATCH (2 teacher batches with the FGR2R and
    summarization heads, 2 DAgger batches), validation of
    RUN_GEN_VAL_EPISODES episodes of each task, no checkpoint. Gates:
    losses finite and below MAX_LOSS, K1-K3 as the path implies with the
    heads' grad calls counted, and one head call's gradient through the
    kernels against eager attention. Returns the run's kernel launches."""
    root = f"{tmp}/rungen"
    T.make_r2r_world(root, n_episodes=TRAIN_EPISODES, seed=8, split="train")
    T.make_r2r_world(root, n_episodes=RUN_GEN_VAL_EPISODES, seed=9,
                     split="val")
    ycfg = load_yaml_text(RUN_GEN_YAML % {"len": MAX_ACTION_LEN})
    args = TrainArgs(data_dir=root, output_dir=f"{root}/out", stage="multi",
                     num_epochs=1, num_steps_per_epoch=4,
                     batch_size=TRAIN_BATCH, val_batch_size=N_SLOTS,
                     gradient_accumulation_step=2,
                     fused_rows_per_call=ROWS_PER_CALL,
                     max_saved_checkpoints=0, enable_summarize=True,
                     enable_fgr2r=True, test_datasets=["R2R", "EQA"], seed=0)
    args.sync_from_config(ycfg)
    runner = NavModelRunner(cfg, model, bpe, dims=DAGGER_DIMS,
                            feat_dropout=args.feat_dropout, seed=args.seed)
    rec = {"batch_s": [], "head_s": [], "heads": [], "losses": [],
           "tokens": [0], "first_head": [], "epochs": []}
    nav_call, gen_call = runner.pano_navigation_train, \
        runner.pano_generation_train

    def nav_train(pano_inputs, seed, batch, targets, coef):
        rec["tokens"][0] += int(batch["attention_mask"][
            targets != args.ignoreid].sum())
        return nav_call(pano_inputs, seed, batch, targets, coef)

    def gen_train(pano_inputs, seed, batch, coef):
        rec["tokens"][0] += int(batch["attention_mask"].sum())
        rec["heads"][-1] += 1
        if not rec["first_head"]:
            rec["first_head"].append((pano_inputs, seed, batch, coef))
        return cuda_timed(gen_call, rec["head_s"][-1])(pano_inputs, seed,
                                                       batch, coef)

    runner.pano_navigation_train, runner.pano_generation_train = \
        nav_train, gen_train
    agent_train, epoch_fn = R2RAgent.train, TTL.train_one_epoch

    def train(self, name, batch, a, config, dataset, step=0, **kw):
        rec["heads"].append(0)
        rec["head_s"].append([])
        loss = cuda_timed(agent_train, rec["batch_s"])(
            self, name, batch, a, config, dataset, step=step, **kw)
        rec["losses"].append(float(loss))
        return loss

    def train_one_epoch(*a, **kw):
        t0 = time.perf_counter()
        out = epoch_fn(*a, **kw)
        torch.cuda.synchronize()
        rec["epochs"].append((time.perf_counter() - t0, out))
        return out

    R2RAgent.train, TTL.train_one_epoch = train, train_one_epoch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(runner)
    try:
        t0 = time.perf_counter()
        res = TTL.run_training(args, ycfg, feat_dbs={
            "mp3d": SyntheticImageFeaturesDB(cfg.pano.image_feat_size)},
            runner=runner)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        R2RAgent.train, TTL.train_one_epoch = agent_train, epoch_fn
    launches = check_launches(24, runner, cfg.llm.num_layers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (train_s, (avg_loss, norms)), = rec["epochs"]
    norms = [float(n) for n in norms]
    losses = rec["losses"]
    if len(losses) != 4 or not all(math.isfinite(x) and 0 < x < MAX_LOSS
                                   for x in losses) \
            or len(norms) != 2 or not all(math.isfinite(n) and n > 0
                                          for n in norms):
        raise RuntimeError(f"[24] losses {losses}, gradient norms {norms}")
    teacher = [i for i in range(4) if i % 2 == 0]
    if not all(rec["heads"][i] >= 2 for i in teacher) or \
            any(rec["heads"][i] for i in range(4) if i % 2):
        raise RuntimeError(f"[24] head calls per batch {rec['heads']}: each "
                           f"teacher batch runs FGR2R and summarization, no "
                           f"DAgger batch runs a head")
    if sorted(res) != ["EQA", "R2R"] or not all(
            math.isfinite(res[t][k]) for t, k in (("R2R", "spl"),
                                                  ("EQA", "exact_match"))):
        raise RuntimeError(f"[24] validation results {res}")
    head_ms = [1e3 * sum(rec["head_s"][i]) for i in range(4)]
    batch_ms = [1e3 * x for x in rec["batch_s"]]
    print(f"[24] run_training (stage multi, --enable_summarize "
          f"--enable_fgr2r, --test_datasets R2R EQA) in {dt:.3f} s: teacher "
          f"batch {[round(batch_ms[i], 1) for i in teacher]} ms = nav "
          f"{[round(batch_ms[i] - head_ms[i], 1) for i in teacher]} + heads "
          f"{[round(head_ms[i], 1) for i in teacher]} ms ("
          f"{[rec['heads'][i] for i in teacher]} head calls per batch); "
          f"DAgger batch {[round(batch_ms[i], 1) for i in range(4) if i % 2]}"
          f" ms; {rec['tokens'][0]} trained tokens in the {train_s:.3f} s "
          f"epoch = {rec['tokens'][0] / train_s:.0f} tokens/s; "
          f"{runner.grad_calls} grad calls ({runner.gen_grad_calls} heads), "
          f"{runner.generate_calls} generate calls; peak memory {peak:.2f} "
          f"GiB; losses {[round(x, 4) for x in losses]}; grad norms "
          f"{[round(n, 4) for n in norms]}; validation R2R "
          f"{({k: round(float(v), 2) for k, v in res['R2R'].items()})}, EQA "
          f"exact match {res['EQA']['exact_match']:.2f}; launches {launches}")
    gen_grad_ab(bpe, cfg, model, rec["first_head"][0])
    return launches


def gen_grad_ab(bpe, cfg, model, call, tag=24, dims=DAGGER_DIMS):
    """Phase 24's first head call (or phase 31's first ScanQA batch) again,
    dropout off, through the kernels and through eager attention: the
    gradients within MIN_GRAD_COSINE."""
    last = cfg.llm.num_layers - 1
    watch = {"llm.layers.wq[0]": lambda m: m.llm.layers.wq.grad[0],
             f"llm.layers.w_down[{last}]":
                 lambda m: m.llm.layers.w_down.grad[last],
             "llm.lm_head": lambda m: m.llm.lm_head.grad,
             "pano.mapper.w": lambda m: m.pano.mapper.w.grad}
    res = {}
    for impl in ("auto", "eager"):
        cfg_i = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, attn_impl=impl),
            pano=dataclasses.replace(cfg.pano, hidden_dropout_prob=0.0))
        runner = NavModelRunner(cfg_i, model, bpe, dims=dims,
                                feat_dropout=0.0)
        runner.zero_grads()
        loss = float(runner.pano_generation_train(*call))
        res[impl] = (loss, {k: f(model).float().clone()
                            for k, f in watch.items()})
    (lk, gk), (le, ge) = res["auto"], res["eager"]
    rows = call[2]["input_ids"].shape
    print(f"[{tag}] one generation-loss call of {rows[0]} rows x {rows[1]} "
          f"tokens: loss kernel {lk:.6f} eager {le:.6f} (diff "
          f"{abs(lk - le):.3e})")
    for name in watch:
        a, w = gk[name].flatten(), ge[name].flatten()
        cos = torch.nn.functional.cosine_similarity(a, w, dim=0).item()
        print(f"[{tag}] {name}: rel L2 err "
              f"{((a - w).norm() / w.norm()).item():.3e}, cosine {cos:.6f}")
        if not cos >= MIN_GRAD_COSINE:
            raise RuntimeError(f"[{tag}] {name}: gradient cosine {cos} < "
                               f"{MIN_GRAD_COSINE}")


def phase_eqa_w4(bpe, cfg, qmodel, tmp, ref):
    """Phase 25: phase 23's evaluation (uncached) on the int4 tree, K4 at
    the decode shape m = N_SLOTS against its plain version per element, and
    one decode step's logits through K4 against q4_impl="plain" under the
    CACHED_LOGIT_* bound. Returns (the evaluation's measures, K4's rows at
    m = N_SLOTS)."""
    st = phase_eqa(25, bpe, cfg, qmodel, tmp)
    q4 = phase_q4_kernel(tag=25, rows=(N_SLOTS,), modes=("w4",))
    runner, ids, mask, inj_pos, inj_emb = gen_inputs(bpe, cfg, qmodel, tmp)
    llm = qmodel["llm"]
    b_ids, b_mask, b_pos = D.bucket_prompt(ids, mask, inj_pos, bpe.pad_id)
    dev_mask = runner.upload(b_mask)
    with torch.inference_mode():
        logits, kv = D.prefill(llm, cfg.llm, runner.upload(
            b_ids.astype(np.int64)), dev_mask, runner.upload(b_pos), inj_emb)
        tok0 = logits.masked_fill(runner.special_mask, NEG_INF).argmax(-1)
        emb0 = L.embed_rows(llm["embed"], tok0)[:, None]
        out = {}
        for impl in ("auto", "plain"):
            c = dataclasses.replace(cfg.llm, q4_impl=impl)
            h, _ = L.decode_step(llm, c, emb0, kv, dev_mask,
                                 L.init_decode_cache(c, N_SLOTS, 1,
                                                     runner.device),
                                 0, dev_mask.sum(-1)[:, None])
            out[impl] = L.logits_from_hidden(llm, c, h[:, 0],
                                             runner.special_mask)
    exc = logit_excess(out["auto"], out["plain"])
    if not exc <= 1:
        raise RuntimeError(f"[25] a decode step's logits through K4 vs its "
                           f"plain version at {exc:.3f} of the limit")
    print(f"[25] one decode step of {N_SLOTS} rows on the int4 tree, logits "
          f"through K4 vs q4_impl=plain at {exc:.3f} of the limit; "
          f"{st['ms_per_decode']:.2f} ms per decode token (w4) beside phase "
          f"23's {ref['ms_per_decode']:.2f} (bf16); {st['ms_per_step']:.2f} "
          f"against {ref['ms_per_step']:.2f} ms per nav step; peak memory "
          f"{st['peak_gib']:.2f} against {ref['peak_gib']:.2f} GiB")
    return st, q4


def og_dims(dims=None):
    """``dims`` (the eval slices' by default) with room for OG_MAX_OBJECTS
    objects."""
    return dataclasses.replace(dims or slice_dims(),
                               max_objects=OG_MAX_OBJECTS)


def og_obj_dbs(cfg):
    return {style: synthetic_object_db(style, cfg.pano.obj_feat_size,
                                       OG_OBJECTS)
            for style in ("reverie", "soon")}


def og_inputs(bpe, cfg, model, tmp):
    """Phase 26's batch: the first observations of len(OG_AB_HISTORY)
    REVERIE episodes as the OG head assembles them (OG_OBJECTS objects at
    its <cand> tokens, the last row with none), with OG_AB_HISTORY history
    embeds (panorama embeds of the views). Returns (runner, batch with
    obj_embeds on the card)."""
    root = f"{tmp}/og_ab"
    n = len(OG_AB_HISTORY)
    T.make_r2r_world(root, n_episodes=n, seed=12)
    runner = NavModelRunner(cfg, model, bpe, dims=og_dims())
    agent, ds, _ = T.reverie_eval(root, "val", runner, N_SLOTS,
                                  cfg.pano.image_feat_size,
                                  og_obj_dbs(cfg)["reverie"])
    obs = [ds[i]["observations"] for i in range(n)]
    obs[-1] = dict(obs[-1], obj_ids=[], **{
        k: obs[-1][k][:0] for k in ("obj_img_fts", "obj_ang_fts",
                                    "obj_box_fts")})
    pano_in = agent.panorama_inputs(obs)
    out = runner.panorama_dev_dict(pano_in, deterministic=True)
    pe = out["pano_embeds"]
    batch = agent._og_inputs(
        pano_in, True, [ob["instruction"] for ob in obs],
        [["<hist>"] * k for k in OG_AB_HISTORY],
        [list(pe[i, :k].float().cpu().numpy())
         for i, k in enumerate(OG_AB_HISTORY)])
    batch = {k: runner.upload(v) for k, v in batch.items()}
    batch["obj_embeds"] = out["obj_embeds"]
    return runner, batch


def phase_og_ab(bpe, cfg, model, tmp):
    """Phase 26: forward_object_grounding through K1 and through the eager
    attention on the same OG batch: obj_logits within phase 15's
    CACHED_LOGIT_* bound on the valid options, every other option exactly
    NEG_INF (the object-less row keeps option 0 alone), and the same pick
    on every row whose top-2 margin exceeds what the bound can move. Then
    ms per OG forward, K1 and eager."""
    runner, batch = og_inputs(bpe, cfg, model, tmp)
    eager = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, attn_impl="eager"))
    with torch.inference_mode():
        got = forward_object_grounding(model, cfg, batch)["obj_logits"]
        want = forward_object_grounding(model, eager, batch)["obj_logits"]
        ms = {name: cuda_ms(lambda c=c: forward_object_grounding(
            model, c, batch), iters=5) for name, c in (("kernel", cfg),
                                                       ("eager", eager))}
    n_obj = batch["obj_masks"].sum(1)
    valid = torch.arange(got.shape[1], device=got.device)[None, :] \
        <= n_obj[:, None]
    if not ((got[~valid] == NEG_INF).all() and (want[~valid] == NEG_INF)
            .all() and (got[valid] > NEG_INF / 2).all()):
        raise RuntimeError("[26] the options past a row's objects are not "
                           "exactly NEG_INF, or a valid one is")
    exc = logit_excess(got, want)
    if not exc <= 1:
        raise RuntimeError(f"[26] obj_logits through K1 vs eager at {exc:.3f}"
                           f" of the limit")
    parted = []
    for i in range(got.shape[0]):
        if got[i].argmax() == want[i].argmax():
            continue
        tol, _ = logit_tol(want[i:i + 1])
        top = want[i].topk(2)
        margin = (top.values[0] - top.values[1]).item()
        limit = tol[0, top.indices].sum().item()
        if margin > limit:
            raise RuntimeError(f"[26] row {i} picks another object on a "
                               f"top-2 margin {margin:.4f} above the limit "
                               f"{limit:.4f}")
        parted.append((i, round(margin, 5), round(limit, 5)))
    shape = tuple(batch["input_ids"].shape)
    print(f"[26] OG A/B on {shape[0]} REVERIE prompts x {shape[1]} tokens "
          f"({n_obj.tolist()} objects, histories {list(OG_AB_HISTORY)}): "
          f"obj_logits through K1 vs eager attention at {exc:.3f} of the "
          f"limit, options past the objects exactly NEG_INF, rows picking "
          f"apart (row, top-2 margin, limit): {parted}; one OG forward "
          f"{ms['kernel']:.3f} ms through K1, {ms['eager']:.3f} ms eager")


def phase_og_eval(tag, bpe, cfg, model, tmp, task, prefix_cache=False,
                  do_sample=True, n_episodes=OG_EPISODES):
    """Phase 27: REVERIE or SOON streaming evaluation of OG_EPISODES
    episodes (2 slot groups of N_SLOTS, val_max_action_len
    GEN_MAX_ACTION_LEN) with enable_og, sampled at OG_TEMPERATURE unless
    do_sample is off. Gates: every pred_objid one of its final viewpoint's
    objects (None exactly where there is none), SOON's direction finite,
    the metrics finite, K1 once per layer of every uncached step, prefill
    and OG call, and every draw that leaves the argmax of its own logits
    on a top-2 margin within OG_DRAW_TEMPS temperatures (recorded on the
    card, read after the run). Returns the measures and the
    trajectories."""
    runner = NavModelRunner(cfg, model, bpe, dims=og_dims())
    og_s = []
    runner.object_grounding = cuda_timed(runner.object_grounding, og_s)
    root = f"{tmp}/og_{task}"
    T.make_r2r_world(root, n_episodes=n_episodes, seed=13)
    obj_db = og_obj_dbs(cfg)[task.lower()]
    flags = dict(do_sample=True, temperature=OG_TEMPERATURE) \
        if do_sample else {}
    agent, ds, args = T.object_eval(task, root, "val", runner, N_SLOTS,
                                    cfg.pano.image_feat_size, obj_db,
                                    prefix_cache=prefix_cache, **flags)
    draws, select = [], DM.select_actions

    def recording_select(logits, override, sample, temperature, generator,
                         *rest):
        a_t = select(logits, override, sample, temperature, generator, *rest)
        if sample:
            top = logits.topk(2, dim=-1).values
            left = (a_t != logits.argmax(-1)) & (override < 0)
            draws.append((left, top[:, 0] - top[:, 1]))
        return a_t

    DM.select_actions = recording_select
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(runner)
    try:
        t0 = time.perf_counter()
        with torch.inference_mode():
            preds = agent.validate_streaming(
                task, args, T.eval_config(GEN_MAX_ACTION_LEN, task),
                Dataloader(ds, N_SLOTS, shuffle=False), dataset=ds)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        DM.select_actions = select
    launches = check_launches(tag, runner, cfg.llm.num_layers)
    q4 = check_q4(tag, runner, cfg.llm.num_layers)
    left = [m[lf] for lf, m in draws]
    left = torch.cat(left).float().cpu() if left else torch.zeros(0)
    if len(left) and left.max() > OG_DRAW_TEMPS * OG_TEMPERATURE:
        raise RuntimeError(f"[{tag}] a draw left the argmax on a top-2 "
                           f"margin {left.max().item():.4f}")
    n_draws = sum(len(lf) for lf, _ in draws)
    if prefix_cache and (runner.eval_steps or not runner.cached_steps):
        raise RuntimeError(f"[{tag}] the cached run took {runner.eval_steps} "
                           f"uncached steps")
    if len(preds) != len(ds) or runner.og_calls != -(-len(ds) // N_SLOTS):
        raise RuntimeError(f"[{tag}] {len(preds)} predictions for {len(ds)} "
                           f"episodes in {runner.og_calls} OG calls")
    starts = {x["instr_id"]: (x["scan"], x["path"][0]) for x in ds.alldata}
    for p in preds:
        vp = p["trajectory"][-1][-1]
        scan, start = starts[p["instr_id"]]
        ids = list(obj_db.load_feature(scan, vp)[1].get("obj_ids", []))
        ok = p["pred_objid"] in ids if ids else p["pred_objid"] is None
        if task == "SOON" and ids:
            ok = ok and all(math.isfinite(x)
                            for x in p["pred_obj_direction"])
        if not ok or p["trajectory"][0][0] != start:
            raise RuntimeError(f"[{tag}] {p['instr_id']}: pred_objid "
                               f"{p['pred_objid']} of {ids} at {vp}, or it "
                               f"does not start at its start")
    avg, _ = ds.eval_metrics(preds, None, task)
    if not all(math.isfinite(v) for v in avg.values()):
        raise RuntimeError(f"[{tag}] metrics not finite: {avg}")
    steps = runner.eval_steps + runner.cached_steps
    og_total = sum(og_s)
    st = {"ms_per_step": 1e3 * (dt - og_total) / steps,
          "ms_per_og": 1e3 * og_total / len(og_s), "og_calls": len(og_s),
          "episodes_per_s": len(preds) / dt,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches, "q4_launches": q4}
    kind = ("cached" if prefix_cache else "uncached") + (
        f", sampled at T={OG_TEMPERATURE}" if do_sample else ", argmax")
    drawn = (f"{len(left)} of {n_draws} draws left the argmax of their "
             f"logits, on top-2 margins "
             f"{sorted(round(x, 5) for x in left.tolist())}; "
             if do_sample else "")
    cached = f", {runner.prefill_calls} prefills" if prefix_cache else ""
    print(f"[{tag}] {task} streaming eval ({kind}, enable_og) of "
          f"{len(preds)} episodes in {dt:.3f} s = {st['episodes_per_s']:.3f}"
          f" episodes/s: {steps} steps at {st['ms_per_step']:.2f} ms wall per"
          f" step (OG excluded){cached}; {len(og_s)} OG calls at "
          f"{st['ms_per_og']:.1f} ms each; {drawn}"
          f"{({k: round(float(v), 2) for k, v in avg.items()})}; every "
          f"pred_objid one of its viewpoint's {OG_OBJECTS} objects; peak "
          f"memory {st['peak_gib']:.2f} GiB; launches {launches}"
          f"{f', int4 {q4}' if q4 else ''}")
    return st, {p["instr_id"]: p["trajectory"] for p in preds}


def phase_og_evals(bpe, cfg, model, tmp):
    """Phase 27 for REVERIE and SOON: sampled uncached, sampled cached, and
    argmax uncached (how many trajectories the draws at T = 0.01 leave as
    the argmax's). Returns {task: (uncached, cached) measures}."""
    out = {}
    for task in ("REVERIE", "SOON"):
        unc, trajs = phase_og_eval(27, bpe, cfg, model, tmp, task)
        cac, _ = phase_og_eval(27, bpe, cfg, model, tmp, task,
                               prefix_cache=True)
        _, greedy = phase_og_eval(27, bpe, cfg, model, tmp, task,
                                  do_sample=False)
        same = sum(trajs[k] == greedy[k] for k in greedy)
        print(f"[27] {task}: {same} of {len(greedy)} sampled trajectories "
              f"(T={OG_TEMPERATURE}) equal the argmax ones; cached against "
              f"uncached {cac['ms_per_step']:.2f} against "
              f"{unc['ms_per_step']:.2f} ms per step, "
              f"{cac['ms_per_og']:.1f} against {unc['ms_per_og']:.1f} ms per "
              f"OG call")
        out[task] = (unc, cac)
    return out


def phase_run_og(bpe, cfg, model, tmp):
    """Phase 28: run_training at stage multi over R2R, REVERIE and SOON
    with --enable_og --enable_summarize --enable_fgr2r on the 7B-width
    runner: one epoch of 4 batches of TRAIN_BATCH (at OG_SEED: REVERIE
    teacher, SOON DAgger, R2R teacher, REVERIE DAgger; the OG head runs on
    every REVERIE/SOON batch, once per DAgger slot group), validation of
    OG_VAL_EPISODES episodes of each task, no checkpoint. Gates: losses
    finite and below MAX_LOSS, K1-K3 as the path implies with the heads'
    grad calls counted, calc_overall_score finite, and one OG head call's
    gradient through the kernels against eager attention. Returns the
    run's kernel launches."""
    root = f"{tmp}/runog"
    T.make_r2r_world(root, n_episodes=TRAIN_EPISODES, seed=14, split="train")
    T.make_r2r_world(root, n_episodes=OG_VAL_EPISODES, seed=15, split="val")
    ycfg = load_yaml_text(RUN_OG_YAML % {
        "len": MAX_ACTION_LEN, "objects": OG_MAX_OBJECTS,
        "feat": cfg.pano.image_feat_size, "obj": cfg.pano.obj_feat_size})
    args = TrainArgs(data_dir=root, output_dir=f"{root}/out", stage="multi",
                     num_epochs=1, num_steps_per_epoch=4,
                     batch_size=TRAIN_BATCH, val_batch_size=N_SLOTS,
                     gradient_accumulation_step=2,
                     fused_rows_per_call=ROWS_PER_CALL,
                     max_saved_checkpoints=0, enable_og=True,
                     enable_summarize=True, enable_fgr2r=True,
                     test_datasets=["R2R", "REVERIE", "SOON"], seed=OG_SEED)
    args.sync_from_config(ycfg)
    runner = NavModelRunner(cfg, model, bpe, dims=og_dims(DAGGER_DIMS),
                            feat_dropout=args.feat_dropout, seed=args.seed)
    rec = {"batch_s": [], "head_s": [], "og": [], "gen": [], "losses": [],
           "names": [], "tokens": [0], "first_og": [], "epochs": []}
    nav_call, gen_call, og_call = runner.pano_navigation_train, \
        runner.pano_generation_train, runner.pano_og_train

    def nav_train(pano_inputs, seed, batch, targets, coef):
        rec["tokens"][0] += int(batch["attention_mask"][
            targets != args.ignoreid].sum())
        return nav_call(pano_inputs, seed, batch, targets, coef)

    def gen_train(pano_inputs, seed, batch, coef):
        rec["tokens"][0] += int(batch["attention_mask"].sum())
        rec["gen"][-1] += 1
        return cuda_timed(gen_call, rec["head_s"][-1])(pano_inputs, seed,
                                                       batch, coef)

    def og_train(pano_inputs, seed, batch, targets, coef, **kw):
        live = targets != args.ignoreid
        rec["tokens"][0] += int(batch["attention_mask"][live].sum())
        rec["og"][-1] += 1
        if not rec["first_og"] and live.any():
            rec["first_og"].append((pano_inputs, seed, batch, targets, coef))
        return cuda_timed(og_call, rec["head_s"][-1])(pano_inputs, seed,
                                                      batch, targets, coef,
                                                      **kw)

    runner.pano_navigation_train, runner.pano_generation_train, \
        runner.pano_og_train = nav_train, gen_train, og_train
    agent_train, epoch_fn = R2RAgent.train, TTL.train_one_epoch

    def train(self, name, batch, a, config, dataset, step=0, **kw):
        for k in ("og", "gen"):
            rec[k].append(0)
        rec["head_s"].append([])
        rec["names"].append(name)
        loss = cuda_timed(agent_train, rec["batch_s"])(
            self, name, batch, a, config, dataset, step=step, **kw)
        rec["losses"].append(float(loss))
        return loss

    def train_one_epoch(*a, **kw):
        t0 = time.perf_counter()
        out = epoch_fn(*a, **kw)
        torch.cuda.synchronize()
        rec["epochs"].append((time.perf_counter() - t0, out))
        return out

    R2RAgent.train, TTL.train_one_epoch = train, train_one_epoch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(runner)
    try:
        t0 = time.perf_counter()
        res = TTL.run_training(args, ycfg, feat_dbs={
            "mp3d": SyntheticImageFeaturesDB(cfg.pano.image_feat_size)},
            obj_feat_dbs=og_obj_dbs(cfg), runner=runner)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        R2RAgent.train, TTL.train_one_epoch = agent_train, epoch_fn
    launches = check_launches(28, runner, cfg.llm.num_layers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (train_s, (avg_loss, norms)), = rec["epochs"]
    norms = [float(n) for n in norms]
    losses = rec["losses"]
    if len(losses) != 4 or not all(math.isfinite(x) and 0 < x < MAX_LOSS
                                   for x in losses) \
            or len(norms) != 2 or not all(math.isfinite(n) and n > 0
                                          for n in norms):
        raise RuntimeError(f"[28] losses {losses}, gradient norms {norms}")
    want_og = [(0 if n == "R2R" else 1 if i % 2 == 0 else 2)
               for i, n in enumerate(rec["names"])]
    if rec["og"] != want_og or not any(rec["og"]) \
            or runner.og_grad_calls != sum(want_og):
        raise RuntimeError(f"[28] OG head calls per batch {rec['og']} for "
                           f"the tasks {rec['names']}: want {want_og}")
    score = TTL.calc_overall_score(res, ycfg)
    if sorted(res) != ["R2R", "REVERIE", "SOON"] or not math.isfinite(score) \
            or not all(math.isfinite(v) for r in res.values()
                       for v in r.values()):
        raise RuntimeError(f"[28] validation results {res}, score {score}")
    head_ms = [1e3 * sum(x) for x in rec["head_s"]]
    batch_ms = [1e3 * x for x in rec["batch_s"]]
    kinds = ["teacher" if i % 2 == 0 else "DAgger" for i in range(4)]
    per_batch = "; ".join(
        f"{kinds[i]} {rec['names'][i]} {batch_ms[i]:.1f} ms = nav "
        f"{batch_ms[i] - head_ms[i]:.1f} + heads {head_ms[i]:.1f} "
        f"({rec['og'][i]} OG, {rec['gen'][i]} generation calls)"
        for i in range(4))
    print(f"[28] run_training (stage multi over R2R, REVERIE, SOON, "
          f"--enable_og --enable_summarize --enable_fgr2r) in {dt:.3f} s: "
          f"{per_batch}; {rec['tokens'][0]} trained tokens in the "
          f"{train_s:.3f} s epoch = {rec['tokens'][0] / train_s:.0f} "
          f"tokens/s; {runner.grad_calls} grad calls ({runner.og_grad_calls}"
          f" OG, {runner.gen_grad_calls} generation), {runner.og_calls} OG "
          f"calls in validation; peak memory {peak:.2f} GiB; losses "
          f"{[round(x, 4) for x in losses]}; grad norms "
          f"{[round(n, 4) for n in norms]}; overall score {score:.4f}; "
          f"validation "
          f"{({t: {k: round(float(v), 2) for k, v in r.items()} for t, r in res.items()})}"
          f"; launches {launches}")
    og_grad_ab(bpe, cfg, model, rec["first_og"][0])
    return launches


def phase_cli_og(tmp):
    """Phase 28, on the command line: the entry point's main() on the card
    at stage multi over R2R, REVERIE and SOON with --enable_og
    --obj_loss_coef 0.5 --fuse_obj --enable_summarize --enable_fgr2r
    --do_sample --temperature 0.01 (validation sampled) and --test_datasets
    R2R REVERIE SOON, on build_runner's model (2 layers, 4 heads of 64,
    bf16, the object branch fused into the panorama encoder): 1 epoch of 4
    batches of CLI_BATCH. The YAML's feature_database and object_database
    resolve to the synthetic stores where run_training builds them (the
    card's machine has no lmdb; phase 50 reads an HDF5 feature_database). Gates: the loss and
    gradient norms finite, the OG head trained, every task validated, K1-K3
    as the path implies. Returns the run's kernel launches."""
    root = f"{tmp}/cli_og"
    T.make_r2r_world(root, n_episodes=4 * CLI_BATCH, seed=16, split="train")
    T.make_r2r_world(root, n_episodes=CLI_VAL_EPISODES, seed=17, split="val")
    yaml_path = Path(root) / "og.yaml"
    yaml_path.write_text(RUN_OG_YAML.replace(
        "max_objects: %(objects)d}", "max_objects: %(objects)d,\n"
        "          feature_database: {\"mp3d\": \"features.hdf5\"},\n"
        "          object_database: {\"reverie\": \"obj/reverie\", "
        "\"soon\": \"obj/soon\"}}") % {
        "len": MAX_ACTION_LEN, "objects": OG_MAX_OBJECTS, "feat": 32,
        "obj": 16})
    res, runner, (avg_loss, norms), _, dt = cli_main([
        "--cfg_file", str(yaml_path), "--data_dir", root, "--output_dir",
        str(Path(root) / "out"), "--num_epochs", "1",
        "--num_steps_per_epoch", "4", "--batch_size", str(CLI_BATCH),
        "--val_batch_size", str(N_SLOTS), "--seed", str(OG_SEED),
        "--enable_og", "--obj_loss_coef", "0.5", "--fuse_obj",
        "--enable_summarize", "--enable_fgr2r", "--do_sample",
        "--temperature", str(OG_TEMPERATURE), "--test_datasets", "R2R",
        "REVERIE", "SOON"])
    launches = check_launches(28, runner, runner.cfg.llm.num_layers)
    norms = [float(n) for n in norms]
    pano = runner.model["pano"]
    if runner.device.type != "cuda" or not runner.og_grad_calls \
            or not ("obj_linear" in pano and "obj_projector" in pano) \
            or not (math.isfinite(avg_loss) and 0 < avg_loss < MAX_LOSS) \
            or len(norms) != 2 or not all(math.isfinite(n) and n > 0
                                           for n in norms) \
            or sorted(res) != ["R2R", "REVERIE", "SOON"]:
        raise RuntimeError(f"[28] the CLI run: {runner.og_grad_calls} OG grad "
                           f"calls on {runner.device}, loss {avg_loss}, "
                           f"norms {norms}, results {res}")
    print(f"[28] python -m navillm_tpu_torch.train's main() on the card over "
          f"R2R, REVERIE, SOON with --enable_og --obj_loss_coef 0.5 "
          f"--fuse_obj --enable_summarize --enable_fgr2r --do_sample "
          f"--temperature {OG_TEMPERATURE} in {dt:.3f} s: loss "
          f"{avg_loss:.4f}, grad norms {[round(x, 4) for x in norms]}; "
          f"{runner.grad_calls} grad calls ({runner.og_grad_calls} OG), "
          f"{runner.og_calls} OG calls in sampled validation; "
          f"{({t: {k: round(float(v), 2) for k, v in r.items()} for t, r in res.items()})}"
          f"; launches {launches}")
    return launches


def og_grad_ab(bpe, cfg, model, call):
    """Phase 28's first OG head call with a target again, dropout off,
    through the kernels and through eager attention: the gradients, the
    panorama's object branch included, within MIN_GRAD_COSINE."""
    last = cfg.llm.num_layers - 1
    watch = {"llm.layers.wq[0]": lambda m: m.llm.layers.wq.grad[0],
             f"llm.layers.w_down[{last}]":
                 lambda m: m.llm.layers.w_down.grad[last],
             "out_head.w": lambda m: m.out_head.w.grad,
             "obj_pos.w": lambda m: m.obj_pos.w.grad,
             "pano.obj_projector.w": lambda m: m.pano.obj_projector.w.grad}
    res = {}
    for impl in ("auto", "eager"):
        cfg_i = dataclasses.replace(
            cfg, llm=dataclasses.replace(cfg.llm, attn_impl=impl),
            pano=dataclasses.replace(cfg.pano, hidden_dropout_prob=0.0))
        runner = NavModelRunner(cfg_i, model, bpe,
                                dims=og_dims(DAGGER_DIMS), feat_dropout=0.0)
        runner.zero_grads()
        _, loss = runner.pano_og_train(*call)
        res[impl] = (float(loss), {k: f(model).float().clone()
                                   for k, f in watch.items()})
    (lk, gk), (le, ge) = res["auto"], res["eager"]
    rows = call[2]["input_ids"].shape
    print(f"[28] one OG head call of {rows[0]} rows x {rows[1]} tokens "
          f"({int((call[3] != -100).sum())} with a target): loss kernel "
          f"{lk:.6f} eager {le:.6f} (diff {abs(lk - le):.3e})")
    for name in watch:
        a, w = gk[name].flatten(), ge[name].flatten()
        cos = torch.nn.functional.cosine_similarity(a, w, dim=0).item()
        print(f"[28] {name}: rel L2 err "
              f"{((a - w).norm() / w.norm()).item():.3e}, cosine {cos:.6f}")
        if not cos >= MIN_GRAD_COSINE:
            raise RuntimeError(f"[28] {name}: gradient cosine {cos} < "
                               f"{MIN_GRAD_COSINE}")


def cvdn_dims():
    """Phase 29's and 31's padded sizes: the runner's defaults (JAX's),
    which hold 30 steps, the 8x8 grid's nodes and OG_OBJECTS objects, with
    CVDN_PREFIX prefix tokens."""
    return RolloutDims(max_prefix=CVDN_PREFIX)


def phase_cvdn_eval(tag, bpe, cfg, model, tmp, prefix_cache=False,
                    ab=False, n_episodes=CVDN_EPISODES, kv_int8=False):
    """Phase 29: CVDN streaming evaluation (greedy, val_max_action_len
    CVDN_MAX_ACTION_LEN) of CVDN_EPISODES dialogs in 2 slot groups of
    N_SLOTS, uncached or prefix-cached. Gates: every trajectory starts at
    its start panorama, the scores finite, K1 once per layer of every
    uncached step and prefill, the cached run through cached steps only.
    With ``ab`` (a cached run, not timed) every cached step is replayed
    through eval_step on a copy of the same state with the whole prompts,
    the active rows' candidate logits gated per element (CACHED_LOGIT_*),
    as phase 15 does. In a dialog prefix of 300 tokens or more a
    random-weight 7B model's candidate logits move less than that limit
    allows when part of the prefix is hidden, so its power is shown
    relatively: on the AB_SNAPSHOT-th step on which every row appends
    history, the step with each row's last history entry hidden from its
    cache (as many tokens as the step appends) must move the logits at
    least FAULT_RESOLVE times as far as the cached step itself deviates
    there (its last cached token hidden alone is printed). Returns the
    measures and the trajectories."""
    runner = NavModelRunner(cfg, model, bpe, dims=cvdn_dims())
    root = f"{tmp}/cvdn"
    T.make_r2r_world(root, n_episodes=n_episodes, seed=18)
    agent, ds, args = T.cvdn_eval(root, "val", runner, N_SLOTS,
                                  cfg.pano.image_feat_size,
                                  prefix_cache=prefix_cache)
    args.kv_int8 = kv_int8
    widest, tokenize = [0], runner.tokenize_with_positions

    def tokenize_recorded(texts, *a, **kw):
        out = tokenize(texts, *a, **kw)
        widest[0] = max(widest[0], int(out[0].attention_mask.sum(1).max()))
        return out

    runner.tokenize_with_positions = tokenize_recorded
    checks = {"steps": 0, "worst": 0.0, "need": 0.0, "fault": None,
              "token": None, "snap": None, "plen": 0, "found": 0}
    step, windows, seen = runner.eval_step_cached, \
        agent._cached_prompt_windows, []

    def cached_prompt_windows(slots, prompts, *a):
        seen.append(list(prompts))
        return windows(slots, prompts, *a)

    def clone(d):
        return {k: v.clone() for k, v in d.items()}

    def eval_step_cached(state, cache, pano, batch, reset, cur, cand, active,
                         *a, **kw):
        before = (clone(state), clone(cache))
        out = step(state, cache, pano, batch, reset, cur, cand, active, *a,
                   **kw)
        checks["plen"] = max(checks["plen"], int(out[1]["plen"].max()))
        toks, cand_pos, hist_pos, cls_pos = tokenize(seen[-1])
        full = {k: v for k, v in batch.items() if k not in WINDOW_KEYS}
        full.update(input_ids=toks.input_ids,
                    attention_mask=toks.attention_mask,
                    cand_positions=cand_pos, hist_positions=hist_pos,
                    cls_pos=cls_pos)
        rows = torch.as_tensor(active, device=out[3].device)
        want = runner.eval_step(clone(before[0]), pano, full, reset, cur,
                                cand, active)[2][rows]
        exc = cached_logit_excess(out[3][rows], want)
        checks["need"] = max(checks["need"], spread_need(out[3][rows], want))
        checks["steps"] += 1
        checks["worst"] = max(checks["worst"], exc)
        if not exc <= 1:
            raise RuntimeError(f"[{tag}] cached step {checks['steps']} vs "
                               f"eval_step at {exc:.3f} of the limit")
        appended = batch["app_mask"].sum(1)
        if active.all() and (appended > 0).all():
            checks["found"] += 1
        if checks["fault"] is None and checks["found"] == AB_SNAPSHOT:
            checks["snap"] = exc
            def faulty(hide):
                hidden = clone(before[1])
                hidden["plen"] -= torch.as_tensor(hide, dtype=torch.int32,
                                                  device=out[3].device)
                bad = step(clone(before[0]), hidden, pano, batch, reset,
                           cur, cand, active, *a, **kw)[3][rows]
                return (cached_logit_excess(bad, want),
                        spread_need(bad, want))
            checks["token"] = faulty(1)
            checks["fault"] = faulty(appended)
        return out

    if ab:
        runner.eval_step_cached = eval_step_cached
        agent._cached_prompt_windows = cached_prompt_windows
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(runner)
    t0 = time.perf_counter()
    with torch.inference_mode():
        preds = agent.validate_streaming(
            "CVDN", args, T.eval_config(CVDN_MAX_ACTION_LEN, "CVDN"),
            Dataloader(ds, N_SLOTS, shuffle=False), dataset=ds)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = check_launches(tag, runner, cfg.llm.num_layers)
    q4 = check_q4(tag, runner, cfg.llm.num_layers)
    if prefix_cache and (runner.eval_steps != (checks["steps"] if ab else 0)
                         or not runner.cached_steps):
        raise RuntimeError(f"[{tag}] the cached run took {runner.eval_steps} "
                           f"uncached steps of its own")
    # the planted faults' replays are two cached steps more
    if ab and (checks["fault"] is None
               or checks["steps"] + 2 != runner.cached_steps):
        raise RuntimeError(f"[{tag}] {checks['steps']} of "
                           f"{runner.cached_steps} cached steps compared, "
                           f"planted fault {checks['fault']}")
    if len(preds) != len(ds):
        raise RuntimeError(f"[{tag}] {len(preds)} predictions for {len(ds)} "
                           f"dialogs")
    for p in preds:
        if p["trajectory"][0][0] != \
                ds.gt_trajs[p["instr_id"]]["start_pano"]["pano"]:
            raise RuntimeError(f"[{tag}] {p['instr_id']} does not start at "
                               f"its start panorama")
    avg, _ = ds.eval_metrics(preds, None, "CVDN")
    if not all(math.isfinite(v) for v in avg.values()):
        raise RuntimeError(f"[{tag}] metrics not finite: {avg}")
    steps = runner.eval_steps + runner.cached_steps
    lens = sorted(len(p["trajectory"]) for p in preds)
    st = {"ms_per_step": 1e3 * dt / steps, "episodes_per_s": len(preds) / dt,
          "tokens_per_step": runner.llm_token_units / steps,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches, "q4_launches": q4}
    kind = ("cached, int8 cache" if kv_int8 else "cached") if prefix_cache \
        else "uncached"
    if ab:
        print(f"[{tag}] cached CVDN steps vs eval_step on the same states and "
              f"whole prompts: {checks['steps']} steps, the active rows' "
              f"candidate logits at worst {checks['worst']:.3f} of the limit "
              f"(cached_logit_tol; spread {checks['need']:.4f} of "
              f"CACHED_LOGIT_SPREAD {CACHED_LOGIT_SPREAD:.4f}); on step "
              f"{AB_SNAPSHOT} with every row appending, the cached step at "
              f"{checks['snap']:.3f} of the limit, with each row's last "
              f"history entry hidden at {checks['fault'][0]:.3f} (spread "
              f"{checks['fault'][1]:.4f}; last cached token alone: "
              f"{checks['token'][0]:.3f}, spread {checks['token'][1]:.4f}); "
              f"longest prefix {checks['plen']} of {CVDN_PREFIX} tokens")
        if not checks["fault"][0] >= FAULT_RESOLVE * checks["snap"]:
            raise RuntimeError(f"[{tag}] a hidden history entry moves the "
                               f"logits less than {FAULT_RESOLVE}x the "
                               f"cached step's own deviation")
        st["ab"] = {"worst": checks["worst"], "need": checks["need"],
                    "snap": checks["snap"], "fault": checks["fault"],
                    "token": checks["token"]}
        return st, {p["instr_id"]: p["trajectory"] for p in preds}
    print(f"[{tag}] CVDN streaming eval ({kind}, greedy, "
          f"val_max_action_len {CVDN_MAX_ACTION_LEN}) of {len(preds)} "
          f"dialogs in {dt:.3f} s = {st['episodes_per_s']:.3f} episodes/s: "
          f"{steps} steps at {st['ms_per_step']:.2f} ms wall per step"
          f"{f', {runner.prefill_calls} prefills' if prefix_cache else ''}, "
          f"{st['tokens_per_step']:.1f} LLM tokens per step; trajectory "
          f"lengths {lens}; "
          f"{'' if prefix_cache else f'longest prompt {widest[0]} tokens; '}"
          f"{({k: round(float(v), 2) for k, v in avg.items()})}; peak memory "
          f"{st['peak_gib']:.2f} GiB; launches {launches}"
          f"{f', int4 {q4}' if q4 else ''}")
    return st, {p["instr_id"]: p["trajectory"] for p in preds}


def phase_cvdn_evals(bpe, cfg, model, tmp):
    """Phase 29: uncached, the cached A/B run, then the timed cached run,
    with the stop logit lowered by AB_STOP_SHIFT: with random weights the
    agent stops within a few steps, and a CVDN agent walks to the 30-step
    cap over 30 history slots and the longest prefixes. Returns
    (uncached, cached) measures."""
    stop_b = model.out_head.b
    with torch.no_grad():
        stop_b0 = stop_b[0].clone()
        stop_b[0] -= AB_STOP_SHIFT
    try:
        unc, trajs = phase_cvdn_eval(29, bpe, cfg, model, tmp)
        phase_cvdn_eval(29, bpe, cfg, model, tmp, prefix_cache=True, ab=True)
        cac, ctrajs = phase_cvdn_eval(29, bpe, cfg, model, tmp,
                                      prefix_cache=True)
    finally:
        with torch.no_grad():
            stop_b[0] = stop_b0
    same = sum(trajs[k] == ctrajs[k] for k in trajs)
    print(f"[29] cached against uncached: {cac['ms_per_step']:.2f} against "
          f"{unc['ms_per_step']:.2f} ms per step, {cac['tokens_per_step']:.1f}"
          f" against {unc['tokens_per_step']:.1f} LLM tokens per step, "
          f"{cac['episodes_per_s']:.3f} against {unc['episodes_per_s']:.3f} "
          f"episodes/s; {same} of {len(trajs)} trajectories equal")
    return unc, cac


def scanqa_batch(agent, runner, ds):
    """The first N_SLOTS questions as ScanQAAgent.validate assembles them:
    (input_ids, attention_mask, inject positions, inject embeds on the
    card)."""
    random.seed(0)
    batch = ds.collate_batch([ds[i] for i in range(N_SLOTS)])
    pano_out = runner.panorama(agent._pano_batch(batch), deterministic=True)
    C = int(pano_out["pano_masks"].sum(1).max())
    toks, cand_pos, hist_pos, _ = runner.tokenize_with_positions(
        agent.prepare_prompts(batch), max_cands=C, max_hist=1)
    emb = runner.gen_embeds(pano_out["pano_embeds"], pano_out["pano_masks"])
    inj = torch.cat([emb[:, :C].float(), emb.new_zeros(
        (N_SLOTS, 1, runner.cfg.hidden_size), dtype=torch.float32)], 1)
    return (toks.input_ids, toks.attention_mask,
            np.concatenate([cand_pos, hist_pos], 1), inj)


def phase_scanqa(bpe, cfg, model, tmp):
    """Phase 30: ScanQA evaluation (ScanQAAgent.validate: 36 frames per
    question through the panorama, gen_embeds, runner.generate with
    SCANQA_NEW_TOKENS tokens and no trie) of SCANQA_QUESTIONS questions in
    batches of N_SLOTS. First one batch's prefill through K1 against the
    eager attention (the first generated token's logits per element within
    the CACHED_LOGIT_* bound, every prefill row finite), then the timed
    run. Gates: K1 once per layer of every generate call, every answer a
    string, the scores finite. Returns the measures."""
    runner = NavModelRunner(cfg, model, bpe, dims=slice_dims())
    root = f"{tmp}/scanqa"
    T.make_r2r_world(root, n_episodes=SCANQA_QUESTIONS, seed=19)
    agent, ds, args = T.scanqa_eval(root, "val", runner, N_SLOTS,
                                    cfg.pano.image_feat_size)
    ids, mask, inj_pos, inj_emb = scanqa_batch(agent, runner, ds)
    llm, smask, layers = model["llm"], runner.special_mask, cfg.llm.num_layers
    b_ids, b_mask, b_pos = D.bucket_prompt(ids, mask, inj_pos, bpe.pad_id)
    dev_ids, dev_mask, dev_pos = (runner.upload(x) for x in (
        b_ids.astype(np.int64), b_mask, b_pos))
    eager = dataclasses.replace(cfg.llm, attn_impl="eager")
    out = {}
    flash_attention_fwd.launches = 0
    with torch.inference_mode():
        for name, c in (("kernel", cfg.llm), ("eager", eager)):
            x = L.embed_with_injection(llm, dev_ids, dev_pos, inj_emb)
            hidden = L.forward_hidden(llm, c, x, dev_mask)
            out[name] = (hidden, L.logits_from_hidden(llm, c, hidden[:, -1],
                                                      smask))
    if flash_attention_fwd.launches != layers:
        raise RuntimeError(f"[30] {flash_attention_fwd.launches} K1 launches "
                           f"in the prefill, not {layers}")
    if not torch.isfinite(out["kernel"][0]).all():
        raise RuntimeError("[30] the kernel prefill is not finite on every "
                           "row")
    exc = logit_excess(out["kernel"][1], out["eager"][1])
    if not exc <= 1:
        raise RuntimeError(f"[30] first-token logits K1 vs eager at "
                           f"{exc:.3f} of the limit")
    with torch.inference_mode():
        prefill_ms = cuda_ms(lambda: D.prefill(llm, cfg.llm, dev_ids,
                                               dev_mask, dev_pos, inj_emb),
                             iters=5)
        _, kv = D.prefill(llm, cfg.llm, dev_ids, dev_mask, dev_pos, inj_emb)
        dec = L.init_decode_cache(cfg.llm, N_SLOTS, 1, runner.device)
        emb0 = L.embed_rows(llm["embed"], out["kernel"][1].argmax(-1))[:, None]
        events = device_events(lambda: L.decode_step(
            llm, cfg.llm, emb0, kv, dev_mask, dec, 0,
            dev_mask.sum(-1)[:, None]))
    gen_s, prefill_s, decodes = [], [], [0]
    runner.generate = cuda_timed(runner.generate, gen_s)
    prefill, decode_step = D.prefill, L.decode_step

    def counted_decode(*a, **kw):
        decodes[0] += 1
        return decode_step(*a, **kw)

    D.prefill, L.decode_step = cuda_timed(prefill, prefill_s), counted_decode
    random.seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(runner)
    try:
        t0 = time.perf_counter()
        with torch.inference_mode():
            preds = agent.validate("ScanQA", args, None,
                                   Dataloader(ds, N_SLOTS, shuffle=False))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        D.prefill, L.decode_step = prefill, decode_step
    launches = check_launches(30, runner, layers)
    if len(preds) != len(ds) or runner.generate_calls != \
            -(-len(ds) // N_SLOTS) or not all(
                isinstance(p["generated_sentences"][0], str) for p in preds):
        raise RuntimeError(f"[30] {len(preds)} answers for {len(ds)} "
                           f"questions in {runner.generate_calls} generate "
                           f"calls")
    avg, _ = ds.eval_metrics(preds, None, "ScanQA")
    if not all(math.isfinite(v) for v in avg.values()):
        raise RuntimeError(f"[30] scores not finite: {avg}")
    gen_total = sum(gen_s)
    st = {"ms_per_generate": 1e3 * gen_total / len(gen_s),
          "ms_per_decode": 1e3 * (gen_total - sum(prefill_s))
          / max(decodes[0], 1), "prefill_ms": prefill_ms, "events": events,
          "questions_per_s": len(preds) / dt,
          "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches}
    print(f"[30] ScanQA A/B on {N_SLOTS} questions of {ids.shape[1]} tokens "
          f"({int((inj_pos[0, :-1] >= 0).sum())} frames injected per row, "
          f"bucketed to {b_ids.shape[1]}): first-token logits K1 vs eager "
          f"attention at {exc:.3f} of the limit, every prefill row finite; "
          f"prefill {prefill_ms:.2f} ms; {events or 'not measured:'} device "
          f"events per decode step{'' if events else ' the trace holds none'}"
          )
    print(f"[30] ScanQA evaluation (ScanQAAgent.validate) of {len(preds)} "
          f"questions in {dt:.3f} s = {st['questions_per_s']:.3f} questions/s:"
          f" {runner.generate_calls} generate calls at "
          f"{st['ms_per_generate']:.1f} ms each ({decodes[0]} decode steps, "
          f"{st['ms_per_decode']:.2f} ms per decode token); BLEU-4 "
          f"{avg['bleu-4']:.2f}, CIDEr {avg['cider']:.2f}, exact match "
          f"{avg['exact_match']:.2f}, ROUGE-L {avg['rouge']:.2f}"
          f"{'' if 'meteor' in avg else ' (METEOR: no java or jar here)'}; "
          f"peak memory {st['peak_gib']:.2f} GiB; launches {launches}")
    return st


def phase_run_mix(bpe, cfg, model, tmp):
    """Phase 31: run_training at stage multi over configs/multi.yaml's six
    sources at its ratios, with --enable_og --enable_summarize
    --enable_fgr2r, on the 7B-width runner (cvdn_dims): one epoch of 4
    batches of TRAIN_BATCH (at MIX_SEED: a CVDN teacher batch, a CVDN DAgger
    batch, a LLaVA batch and a ScanQA batch), then validation of
    MIX_VAL_EPISODES CVDN dialogs (streaming) and ScanQA questions (its
    agent's validate). Gates: the planned tasks, losses finite and below
    MAX_LOSS, gradient norms finite and > 0, K1-K3 as the path implies,
    the scores finite, and the first ScanQA batch's gradient through the
    kernels against eager attention. Returns (the run's kernel launches, its
    peak memory in GiB)."""
    from navillm_tpu_torch.agents.llava_agent import LLaVAAgent
    root = f"{tmp}/runmix"
    T.make_r2r_world(root, n_episodes=TRAIN_EPISODES, seed=20, split="train")
    T.make_r2r_world(root, n_episodes=MIX_VAL_EPISODES, seed=21, split="val")
    ycfg = load_yaml_text(run_mix_yaml(cfg.pano.image_feat_size,
                                       cfg.pano.obj_feat_size))
    args = TrainArgs(data_dir=root, output_dir=f"{root}/out", stage="multi",
                     num_epochs=1, num_steps_per_epoch=4,
                     batch_size=TRAIN_BATCH, val_batch_size=N_SLOTS,
                     gradient_accumulation_step=2,
                     fused_rows_per_call=ROWS_PER_CALL,
                     max_saved_checkpoints=0, enable_og=True,
                     enable_summarize=True, enable_fgr2r=True,
                     test_datasets=["CVDN", "ScanQA"], seed=MIX_SEED)
    args.sync_from_config(ycfg)
    runner = NavModelRunner(cfg, model, bpe, dims=cvdn_dims(),
                            feat_dropout=args.feat_dropout, seed=args.seed)
    rec = {"batch_s": [], "losses": [], "names": [], "tokens": [0],
           "first_qa": [], "epochs": []}
    nav_call, gen_call, og_call = runner.pano_navigation_train, \
        runner.pano_generation_train, runner.pano_og_train

    def nav_train(pano_inputs, seed, batch, targets, coef):
        rec["tokens"][0] += int(batch["attention_mask"][
            targets != args.ignoreid].sum())
        return nav_call(pano_inputs, seed, batch, targets, coef)

    def gen_train(pano_inputs, seed, batch, coef):
        rec["tokens"][0] += int(batch["attention_mask"].sum())
        if rec["names"][-1] == "ScanQA" and not rec["first_qa"]:
            rec["first_qa"].append((pano_inputs, seed, batch, coef))
        return gen_call(pano_inputs, seed, batch, coef)

    def og_train(pano_inputs, seed, batch, targets, coef, **kw):
        rec["tokens"][0] += int(batch["attention_mask"][
            targets != args.ignoreid].sum())
        return og_call(pano_inputs, seed, batch, targets, coef, **kw)

    runner.pano_navigation_train, runner.pano_generation_train, \
        runner.pano_og_train = nav_train, gen_train, og_train
    saved = (R2RAgent.train, LLaVAAgent.train, TTL.train_one_epoch)

    def timed(fn):
        def train(self, name, *a, **kw):
            rec["names"].append(name)
            loss = cuda_timed(fn, rec["batch_s"])(self, name, *a, **kw)
            rec["losses"].append(float(loss))
            return loss
        return train

    def train_one_epoch(*a, **kw):
        t0 = time.perf_counter()
        out = saved[2](*a, **kw)
        torch.cuda.synchronize()
        rec["epochs"].append((time.perf_counter() - t0, out))
        return out

    R2RAgent.train, LLaVAAgent.train, TTL.train_one_epoch = \
        timed(saved[0]), timed(saved[1]), train_one_epoch
    random.seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(runner)
    try:
        t0 = time.perf_counter()
        res = TTL.run_training(args, ycfg, feat_dbs=T.feature_dbs(
            cfg.pano.image_feat_size), obj_feat_dbs=og_obj_dbs(cfg),
            runner=runner)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        R2RAgent.train, LLaVAAgent.train, TTL.train_one_epoch = saved
    launches = check_launches(31, runner, cfg.llm.num_layers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    (train_s, (avg_loss, norms)), = rec["epochs"]
    norms = [float(n) for n in norms]
    losses = rec["losses"]
    if rec["names"] != MIX_TASKS:
        raise RuntimeError(f"[31] trained {rec['names']}, planned {MIX_TASKS}")
    if not all(math.isfinite(x) and 0 < x < MAX_LOSS for x in losses) \
            or len(norms) != 2 or not all(math.isfinite(n) and n > 0
                                          for n in norms):
        raise RuntimeError(f"[31] losses {losses}, gradient norms {norms}")
    if sorted(res) != ["CVDN", "ScanQA"] or not all(
            math.isfinite(v) for r in res.values() for v in r.values()):
        raise RuntimeError(f"[31] validation results {res}")
    kinds = ["CVDN teacher", "CVDN DAgger", "LLaVA", "ScanQA"]
    per_batch = "; ".join(f"{k} {1e3 * t:.1f} ms"
                          for k, t in zip(kinds, rec["batch_s"]))
    print(f"[31] run_training (stage multi over {len(ycfg.Multi.SOURCE)} "
          f"sources at ratios {list(ycfg.Multi.Ratio)}, --enable_og "
          f"--enable_summarize --enable_fgr2r, --test_datasets CVDN ScanQA) "
          f"in {dt:.3f} s: {per_batch}; {rec['tokens'][0]} trained tokens in "
          f"the {train_s:.3f} s epoch = {rec['tokens'][0] / train_s:.0f} "
          f"tokens/s; {runner.grad_calls} grad calls "
          f"({runner.gen_grad_calls} generation-loss, {runner.og_grad_calls} "
          f"OG), {runner.generate_calls} generate calls in validation; peak "
          f"memory {peak:.2f} GiB; losses {[round(x, 4) for x in losses]}; "
          f"grad norms {[round(n, 4) for n in norms]}; validation "
          f"{({t: {k: round(float(v), 2) for k, v in r.items()} for t, r in res.items()})}"
          f"; launches {launches}")
    gen_grad_ab(bpe, cfg, model, rec["first_qa"][0], tag=31,
                dims=cvdn_dims())
    return launches, peak


def phase_cli_mix(tmp, stage):
    """Phase 32: the entry point's main() on the card over configs/multi
    .yaml's sources of ``stage`` at its ratios (stage pretrain: the
    augmented sets' .json files) with --enable_og --enable_summarize
    --enable_fgr2r and --test_datasets CVDN ScanQA, on build_runner's small
    bf16 model: 1 epoch of 4 batches of CLI_BATCH. The YAML's
    feature_database (mp3d, scan_qa, coco) and object_database resolve to
    the synthetic stores where run_training builds them (the card's machine
    has no lmdb; phase 50 reads an HDF5 feature_database). Gates: the loss and gradient norms finite,
    CVDN and ScanQA validated, K1-K3 as the path implies. Returns the run's
    kernel launches."""
    root = f"{tmp}/cli_{stage}"
    T.make_r2r_world(root, n_episodes=4 * CLI_BATCH, seed=22, split="train")
    T.make_r2r_world(root, n_episodes=CLI_VAL_EPISODES, seed=23, split="val")
    yaml_path = Path(root) / "mix.yaml"
    yaml_path.write_text(run_mix_yaml(32, 16, stores=(
        ',\n          feature_database: {"mp3d": "mp3d.hdf5", '
        '"scan_qa": "scanqa.hdf5", "coco": "coco.hdf5"},\n'
        '          object_database: {"reverie": "obj/reverie", '
        '"soon": "obj/soon"}')))
    random.seed(0)
    res, runner, (avg_loss, norms), names, dt = cli_main([
        "--cfg_file", str(yaml_path), "--data_dir", root, "--output_dir",
        f"{root}/out", "--stage", stage, "--num_epochs", "1",
        "--num_steps_per_epoch", "4", "--batch_size", str(CLI_BATCH),
        "--val_batch_size", str(N_SLOTS), "--seed",
        str(CLI_MIX_SEEDS[stage]), "--save_ckpt_per_epochs", "100",
        "--max_saved_checkpoints", "0", "--enable_og", "--enable_summarize",
        "--enable_fgr2r", "--test_datasets", "CVDN", "ScanQA"])
    launches = check_launches(32, runner, runner.cfg.llm.num_layers)
    norms = [float(n) for n in norms]
    if runner.device.type != "cuda" or len(names) != 4 \
            or not (math.isfinite(avg_loss) and 0 < avg_loss < MAX_LOSS) \
            or len(norms) != 2 or not all(math.isfinite(n) and n > 0
                                           for n in norms) \
            or sorted(res) != ["CVDN", "ScanQA"]:
        raise RuntimeError(f"[32] the CLI run at stage {stage} on "
                           f"{runner.device}: tasks {names}, loss {avg_loss}, "
                           f"norms {norms}, results {res}")
    print(f"[32] python -m navillm_tpu_torch.train's main() on the card at "
          f"stage {stage} (--enable_og --enable_summarize --enable_fgr2r "
          f"--test_datasets CVDN ScanQA) in {dt:.3f} s: batches {names}, loss "
          f"{avg_loss:.4f}, grad norms {[round(x, 4) for x in norms]}; "
          f"{runner.grad_calls} grad calls ({runner.gen_grad_calls} "
          f"generation-loss, {runner.og_grad_calls} OG), "
          f"{runner.generate_calls} generate calls; "
          f"{({t: {k: round(float(v), 2) for k, v in r.items()} for t, r in res.items()})}"
          f"; launches {launches}")
    return launches


@contextlib.contextmanager
def hf_home(path):
    """$HF_HOME set to ``path``, every other variable naming a Hugging
    Face cache cleared; restored on exit."""
    saved = {k: os.environ.pop(k, None) for k in HF_CACHE_VARS}
    os.environ["HF_HOME"] = str(path)
    try:
        yield
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def phase_cli_jsonl(tmp):
    """Phase 32, continued: main() at stage pretrain as above, with the
    augmented R2R and REVERIE sets read from their .jsonl files
    (bert-base-uncased ids), once through the default decoder over an
    offline Hugging Face cache (testing.write_bert_cache, $HF_HOME pointed
    at it) and once with testing.aug_decoder injected. Gates: every .jsonl
    instruction the default decoder gives equal to aug_decoder's; the first
    run built the default decoder for both augmented sets, the second
    never; both runs' batches, per-batch losses and gradient norms equal
    bit for bit; K1-K3 as the path implies in each. Returns (the first
    run's launches, its seconds)."""
    root = f"{tmp}/cli_jsonl"
    T.make_r2r_world(root, n_episodes=4 * CLI_BATCH, seed=22, split="train")
    T.make_r2r_world(root, n_episodes=CLI_VAL_EPISODES, seed=23, split="val")
    yaml_path = Path(root) / "mix.yaml"
    yaml_path.write_text(run_mix_yaml(32, 16, stores=(
        ',\n          feature_database: {"mp3d": "mp3d.hdf5", '
        '"scan_qa": "scanqa.hdf5", "coco": "coco.hdf5"},\n'
        '          object_database: {"reverie": "obj/reverie", '
        '"soon": "obj/soon"}'), aug="jsonl"))
    T.write_bert_cache(f"{tmp}/hf")
    classes = (AUG.R2RAugDataset, AUG.REVERIEAugDataset)
    runs = []
    with hf_home(f"{tmp}/hf"):
        decode = AUG._default_decoder()
        n = 0
        for task in ("R2R", "REVERIE"):
            for line in Path(f"{root}/{task}/annotations/train_aug.jsonl"
                             ).read_text().splitlines():
                ids = json.loads(line)["instr_encoding"]
                if decode(ids) != T.aug_decoder(ids):
                    raise RuntimeError(f"[32] the default decoder gives "
                                       f"{decode(ids)!r} for {ids}, "
                                       f"aug_decoder {T.aug_decoder(ids)!r}")
                n += 1
        for inject in (False, True):
            default, built, losses = AUG._default_decoder, [], []

            def counted():
                built.append(1)
                return default()
            AUG._default_decoder = counted
            for cls in classes:
                cls.decoder = staticmethod(T.aug_decoder) if inject else None
            random.seed(0)
            try:
                res, runner, (avg_loss, norms), names, dt = cli_main([
                    "--cfg_file", str(yaml_path), "--data_dir", root,
                    "--output_dir", f"{root}/out_{inject}", "--stage",
                    "pretrain", "--num_epochs", "1", "--num_steps_per_epoch",
                    "4", "--batch_size", str(CLI_BATCH), "--val_batch_size",
                    str(N_SLOTS), "--seed", str(CLI_MIX_SEEDS["pretrain"]),
                    "--save_ckpt_per_epochs", "100", "--max_saved_checkpoints",
                    "0", "--enable_og", "--enable_summarize",
                    "--enable_fgr2r", "--test_datasets", "CVDN", "ScanQA"],
                    losses=losses)
            finally:
                AUG._default_decoder = default
                for cls in classes:
                    cls.decoder = None
            launches = check_launches(32, runner, runner.cfg.llm.num_layers)
            runs.append({"names": names, "losses": [float(x) for x in losses],
                         "norms": [float(x) for x in norms], "built":
                         len(built), "launches": launches, "seconds": dt,
                         "device": runner.device.type})
            del runner
    a, b = runs
    if a["built"] < 2 or b["built"] \
            or {"R2R_AUG", "REVERIE_AUG"} - set(a["names"]):
        raise RuntimeError(f"[32] default decoder built {a['built']} / "
                           f"{b['built']} times, batches {a['names']}")
    if (a["names"], a["losses"], a["norms"]) != \
            (b["names"], b["losses"], b["norms"]) \
            or not all(math.isfinite(x) for x in a["losses"] + a["norms"]):
        raise RuntimeError(f"[32] .jsonl through the default decoder: "
                           f"batches {a['names']}, losses {a['losses']}, norms "
                           f"{a['norms']}; with aug_decoder injected "
                           f"{b['names']}, {b['losses']}, {b['norms']}")
    if a["device"] != "cuda":
        raise RuntimeError(f"[32] the .jsonl runs ran on {a['device']}")
    print(f"[32] main() at stage pretrain with the augmented sets' .jsonl "
          f"files: {n} instructions decoded by the default decoder "
          f"(bert-base-uncased from an offline cache under $HF_HOME) equal to "
          f"aug_decoder's; batches {a['names']}, losses "
          f"{[round(x, 4) for x in a['losses']]} and grad norms "
          f"{[round(x, 4) for x in a['norms']]} equal bit for bit to the run "
          f"with aug_decoder injected ({a['seconds']:.3f} s against "
          f"{b['seconds']:.3f} s); launches {a['launches']}")
    return a["launches"], a["seconds"]


# --------------------------------------------- the per-step paths (36-40) --- #
# phase 38: run_training's batched validation (--no-streaming_eval) of
# N_EPISODES R2R episodes and BATCHED_EQA_EPISODES EQA ones with the oracle
# pass; phase 39: the host-memory runner's streaming eval of HOSTMEM_EPISODES
# episodes; phase 40: one EQA training batch of TRAIN_BATCH per rollout
BATCHED_EQA_EPISODES = 16
HOSTMEM_EPISODES = 8


def perstep_runner(bpe, cfg, model, args, dropout=True, device_memory=True):
    """A runner on DAGGER_DIMS for the per-step phases; without dropout (the
    A/B runs) neither the features nor the panorama's hidden states drop."""
    if not dropout:
        cfg = dataclasses.replace(cfg, pano=dataclasses.replace(
            cfg.pano, hidden_dropout_prob=0.0))
    return NavModelRunner(cfg, model, bpe, dims=DAGGER_DIMS,
                          feat_dropout=args.feat_dropout if dropout else 0.0,
                          seed=args.seed, device_memory=device_memory)


def perstep_args(cfg, **flags):
    """Stage multi, batches of TRAIN_BATCH in chunks of ROWS_PER_CALL rows,
    gradient accumulation 2, and ``flags``."""
    return TrainArgs(stage="multi", image_feat_size=cfg.pano.image_feat_size,
                     fused_rows_per_call=ROWS_PER_CALL,
                     gradient_accumulation_step=2, seed=0, **flags)


def grads_of(model):
    """A copy of every parameter's accumulated gradient."""
    return [p.grad.detach().clone() for p in model.parameters()]


def grad_cosine(saved, model) -> float:
    """Cosine of the whole gradient (every leaf, in f32 slices of 2^26
    elements) between ``saved`` and the model's .grad."""
    dot = na = nb = 0.0
    for a, p in zip(saved, model.parameters()):
        a, b = a.flatten(), p.grad.detach().flatten()
        for s in range(0, a.numel(), 1 << 26):
            x, y = a[s: s + (1 << 26)].float(), b[s: s + (1 << 26)].float()
            dot += float((x * y).sum())
            na += float((x * x).sum())
            nb += float((y * y).sum())
    return dot / math.sqrt(na * nb)


def per_grad_call(launches, calls):
    return {k: round(v / max(calls, 1), 2) for k, v in launches.items()}


def phase_perstep_train(bpe, cfg, model, tmp):
    """Phase 36: train_one_epoch at stage multi through the per-step
    rollouts (--no-fused_teacher --no-fused_dagger --dagger_streams 1: one
    grad call per step, the DAgger's actions drawn on the host), a warm-up
    epoch, then 4 batches of TRAIN_BATCH (2 teacher, 2 DAgger; AdamW, 2
    optimizer steps). Gates: losses finite and below MAX_LOSS, gradient
    norms finite and above 0, no eval step (the per-step path's DAgger
    draws on the host), K1 twice and K2, K3 once per layer of every grad call.
    Then phase_perstep_ab. Returns the measured run's launches."""
    args = perstep_args(cfg, fused_teacher=False, fused_dagger=False,
                        dagger_streams=1)
    runner = perstep_runner(bpe, cfg, model, args)
    layers = cfg.llm.num_layers
    rec = {"teacher_s": [], "dagger_s": [], "losses": []}
    config = T.train_config(MAX_ACTION_LEN)
    tx = make_optimizer(dict(model.named_parameters()), lr=args.lr,
                        num_warmup_steps=args.num_warmup_steps,
                        grad_clip_norm=args.grad_clip_norm)
    agents = []

    def epoch(root, n_episodes, seed):
        anno = T.make_r2r_world(root, n_episodes=n_episodes, seed=seed,
                                split="train")
        agent, ds, loader = T.r2r_train(anno, runner, args, TRAIN_BATCH)
        agents.append(agent)
        train = agent.train

        def recorded_train(name, batch, a, config, dataset, step=0, **kw):
            sink = rec["dagger_s"] if step % 2 else rec["teacher_s"]
            loss = cuda_timed(train, sink)(name, batch, a, config, dataset,
                                           step=step, **kw)
            rec["losses"].append(loss)
            return loss

        agent.train = recorded_train
        return train_one_epoch(
            args, config, runner, tx, make_opt_step(tx),
            MetaLoader({"R2R": (loader, 1.0)}), {"R2R": agent},
            {"R2R": ds}, 0, None, num_batches=len(loader))

    epoch(f"{tmp}/warm", 2 * TRAIN_BATCH, seed=1)
    for v in rec.values():
        v.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counters(runner)
    t0 = time.perf_counter()
    avg_loss, norms = epoch(f"{tmp}/main", TRAIN_EPISODES, seed=0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = check_launches(36, runner, layers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_batches = TRAIN_EPISODES // TRAIN_BATCH
    losses = [float(x) for x in rec["losses"]]
    if len(losses) != n_batches or not all(
            math.isfinite(x) and 0 < x < MAX_LOSS for x in losses):
        raise RuntimeError(f"[36] losses {losses}: not all finite and in "
                           f"(0, {MAX_LOSS})")
    norms = [float(n) for n in norms]
    if len(norms) != n_batches // args.gradient_accumulation_step or not all(
            math.isfinite(n) and n > 0 for n in norms):
        raise RuntimeError(f"[36] global gradient norms {norms}")
    if runner.eval_steps or runner.cached_steps or runner.forward_calls \
            or not runner.grad_calls:
        raise RuntimeError(f"[36] the per-step rollouts took another path: "
                           f"{runner.eval_steps} eval steps, "
                           f"{runner.cached_steps} cached, "
                           f"{runner.forward_calls} forwards, "
                           f"{runner.grad_calls} grad calls")
    timer = agents[-1].timer
    print(f"[36] stage multi through the per-step rollouts, "
          f"{TRAIN_EPISODES} episodes in {dt:.3f} s = "
          f"{TRAIN_EPISODES / dt:.3f} episodes/s, {len(norms)} optimizer "
          f"steps; teacher batch "
          f"{[round(1e3 * x, 1) for x in rec['teacher_s']]} ms, DAgger batch "
          f"{[round(1e3 * x, 1) for x in rec['dagger_s']]} ms; "
          f"{runner.grad_calls} grad calls of {TRAIN_BATCH} rows (one per "
          f"step), launches per grad call "
          f"{per_grad_call(launches, runner.grad_calls)}; peak memory "
          f"{peak:.2f} GiB; losses {[round(x, 4) for x in losses]} (mean "
          f"{avg_loss:.4f}); grad norms {[round(n, 4) for n in norms]}; "
          f"launches {launches}")
    print(f"[36] {timer.report()}")
    del tx
    gc.collect()
    torch.cuda.empty_cache()
    phase_perstep_ab(bpe, cfg, model, tmp)
    return launches


def phase_perstep_ab(bpe, cfg, model, tmp):
    """Phase 36's A/B: one teacher batch of TRAIN_BATCH, dropout off and the
    candidates in graph order, through the per-step rollout and through the
    fused teacher (the twin of tests/test_fused_teacher.py's
    per-step-against-fused check): the same trajectories, the losses within
    DAGGER_AB_LOSS_REL, the whole gradients within MIN_GRAD_COSINE."""
    args = perstep_args(cfg)
    runner = perstep_runner(bpe, cfg, model, args, dropout=False)
    anno = T.make_r2r_world(f"{tmp}/perstep_ab", n_episodes=TRAIN_BATCH,
                            seed=3, split="train")
    agent, ds, _ = T.r2r_train(anno, runner, args, TRAIN_BATCH)
    optim = T.train_config(MAX_ACTION_LEN).Optim
    res = {}
    for kind in ("perstep", "fused"):
        agent.np_rng = IdentityPermutation()
        batch = next(iter(Dataloader(ds, TRAIN_BATCH, shuffle=False)))
        runner.zero_grads()
        zero_counters(runner)
        t = []
        if kind == "perstep":
            loss, traj = cuda_timed(agent.rollout, t)(
                args, "R2R", optim, batch, dataset=ds, feedback="teacher",
                train_ml=1.0)
            saved = grads_of(model)
        else:
            loss, traj = cuda_timed(FT.rollout_teacher_fused, t)(
                agent, args, "R2R", optim, batch, dataset=ds, train_ml=1.0)
        res[kind] = (float(loss), [x["path"] for x in traj], t[0],
                     runner.grad_calls)
    cos = grad_cosine(saved, model)
    del saved
    (lp, pp, tp, cp), (lf, pf, tf, cf) = res["perstep"], res["fused"]
    rel = abs(lp - lf) / abs(lf)
    print(f"[36] one teacher batch of {TRAIN_BATCH}, dropout off: per-step "
          f"{1e3 * tp:.1f} ms in {cp} grad calls, fused {1e3 * tf:.1f} ms in "
          f"{cf}; loss per-step {lp:.6f} fused {lf:.6f} (rel {rel:.3e}); "
          f"whole-gradient cosine {cos:.6f}")
    if pp != pf:
        raise RuntimeError("[36] the per-step and fused teacher "
                           "trajectories differ")
    if not rel <= DAGGER_AB_LOSS_REL or not cos >= MIN_GRAD_COSINE:
        raise RuntimeError(f"[36] per-step against fused: loss rel {rel} "
                           f"(limit {DAGGER_AB_LOSS_REL}), gradient cosine "
                           f"{cos} (limit {MIN_GRAD_COSINE})")


def phase_pipeline(bpe, cfg, model, tmp):
    """Phase 37: the per-step DAgger half with --dagger_pipeline over 2
    streams of TRAIN_BATCH // 2 (rollout_interleaved: one stream's host work
    while the other's grad call runs) against draining the same streams in
    sequence, with the same stream RandomStates and dropout off, after a
    warm-up run. Gates: the same trajectories, the whole gradients within
    MIN_GRAD_COSINE, K1-K3 per grad call. Prints both wall times and the
    timer's nav_dispatch / nav_sync. Returns the interleaved run's
    launches."""
    from navillm_tpu_torch.agents.mp3d_agent import _split_batch_dict
    args = perstep_args(cfg, fused_dagger=False, dagger_pipeline=True,
                        dagger_streams=2)
    runner = perstep_runner(bpe, cfg, model, args, dropout=False)
    anno = T.make_r2r_world(f"{tmp}/pipeline", n_episodes=TRAIN_BATCH,
                            seed=6, split="train")
    agent, ds, _ = T.r2r_train(anno, runner, args, TRAIN_BATCH)
    optim = T.train_config(MAX_ACTION_LEN).Optim
    layers = cfg.llm.num_layers
    out = {}
    for kind in ("warm-up", "interleaved", "sequential"):
        batch = next(iter(Dataloader(ds, TRAIN_BATCH, shuffle=False)))
        halves = _split_batch_dict(batch, args.dagger_streams)
        rngs = [np.random.RandomState(100 + k) for k in range(len(halves))]
        agent.timer.reset()
        runner.zero_grads()
        zero_counters(runner)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if kind == "sequential":
            loss, traj = 0.0, []
            for h, rng in zip(halves, rngs):
                part, tr = agent.rollout(args, "R2R", optim, h, dataset=ds,
                                         feedback="sample", train_ml=1.0,
                                         loss_denom=TRAIN_BATCH, np_rng=rng)
                loss, traj = loss + part, traj + tr
        else:
            loss, traj = agent.rollout_interleaved(
                args, "R2R", optim, halves, dataset=ds, feedback="sample",
                train_ml=1.0, stream_rngs=rngs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = check_launches(37, runner, layers)
        out[kind] = (float(loss), [x["path"] for x in traj], dt,
                     agent.timer.summary(), runner.grad_calls, launches)
        if kind == "interleaved":
            saved = grads_of(model)
    cos = grad_cosine(saved, model)
    del saved
    (li, pi, ti, si, ci, launches), (ls, ps, ts, ss, cs, _) = \
        out["interleaved"], out["sequential"]

    def stages(s):
        return {k: (s[k]["count"], round(1e3 * s[k]["total_s"], 1))
                for k in ("nav_dispatch", "nav_sync")}

    print(f"[37] one DAgger batch of {TRAIN_BATCH} in {len(pi)} episodes of 2 "
          f"streams: interleaved {1e3 * ti:.1f} ms, sequential "
          f"{1e3 * ts:.1f} ms ({ci} / {cs} grad calls); (calls, total ms) "
          f"interleaved {stages(si)}, sequential {stages(ss)}; loss "
          f"{li:.6f} / {ls:.6f}; whole-gradient cosine {cos:.6f}; launches "
          f"per grad call {per_grad_call(launches, ci)}")
    if pi != ps or ci != cs:
        raise RuntimeError("[37] interleaved and sequential streams took "
                           "other trajectories")
    if not cos >= MIN_GRAD_COSINE:
        raise RuntimeError(f"[37] interleaved against sequential gradient "
                           f"cosine {cos} < {MIN_GRAD_COSINE}")
    return launches


class StepLogits(contextlib.AbstractContextManager):
    """{(instr_id, step): the logits row [G] (f32, host)} of every
    navigation step of the runs inside the block: nav_gmap_inputs names the
    rows of the step (their episode, and the step from the graph map's step
    id) whose logits the runner's navigation, eval_step or
    eval_step_cached returns next. The
    first entry of a key stays (an ended row's stale repeats, an oracle
    pass's, come later)."""

    def __init__(self, runner):
        self.runner, self.rows, self.logits = runner, [], {}

    def __enter__(self):
        self.gmap_inputs = R2RAgent.nav_gmap_inputs
        self.navigation = self.runner.navigation
        self.eval_step = self.runner.eval_step
        self.eval_step_cached = self.runner.eval_step_cached
        log = self

        def nav_gmap_inputs(agent, obs, gmaps, *a, **kw):
            log.rows = [(ob["instr_id"],
                         g.node_step_ids.get(ob["viewpoint"], 0) - 1)
                        for ob, g in zip(obs, gmaps)]
            return log.gmap_inputs(agent, obs, gmaps, *a, **kw)

        def keep(logits):
            rows = torch.as_tensor(np.asarray(logits.cpu()
                                              if torch.is_tensor(logits)
                                              else logits)).float()
            for key, row in zip(self.rows, rows):
                self.logits.setdefault(key, row)

        def navigation(batch, *a, **kw):
            out = log.navigation(batch, *a, **kw)
            keep(out[0])
            return out

        def eval_step(*a, **kw):
            out = log.eval_step(*a, **kw)
            keep(out[2])
            return out

        def eval_step_cached(*a, **kw):
            out = log.eval_step_cached(*a, **kw)
            keep(out[3])
            return out

        R2RAgent.nav_gmap_inputs = nav_gmap_inputs
        self.runner.navigation, self.runner.eval_step = navigation, eval_step
        self.runner.eval_step_cached = eval_step_cached
        return self

    def __exit__(self, *exc):
        R2RAgent.nav_gmap_inputs = self.gmap_inputs
        self.runner.navigation = self.navigation
        self.runner.eval_step = self.eval_step
        self.runner.eval_step_cached = self.eval_step_cached


def near_tie_parts(tag, got, want, logits, strict: bool = True):
    """The near-tie rule: where ``got``'s trajectory (instr_id -> path)
    parts from ``want``'s, the step at which it parts must have, in want's
    logits, a top-2 margin within logit_tol's bf16 bound (phase 15's
    CACHED_LOGIT_*); without ``strict`` the margins are only reported.
    Returns [(instr_id, step, margin, limit)]."""
    if got.keys() != want.keys():
        raise RuntimeError(f"[{tag}] other episodes: {sorted(got)} against "
                           f"{sorted(want)}")
    parted = []
    for k, w in want.items():
        g = got[k]
        if g == w:
            continue
        n = min(len(g), len(w))
        j = next((i for i in range(n) if g[i] != w[i]), n)
        row = logits.get((k, j - 1))
        if row is None:
            raise RuntimeError(f"[{tag}] {k} parts at step {j - 1}, which "
                               f"has no logits")
        tol, _ = logit_tol(row[None])
        top = row.topk(2)
        margin = (top.values[0] - top.values[1]).item()
        limit = tol[0, top.indices].sum().item()
        if strict and margin > limit:
            raise RuntimeError(f"[{tag}] {k} parts at step {j - 1} on a "
                               f"top-2 margin {margin:.4f} above the bf16 "
                               f"limit {limit:.4f}")
        parted.append((k, j - 1, round(margin, 5), round(limit, 5)))
    return parted


def graph_order_agents(captured):
    """A TTL.build_agents that gives each agent the candidates in graph
    order and records what its validate returns in ``captured`` (task ->
    (predictions, agent, dataset))."""
    build_agents = TTL.build_agents

    def build(*a, **kw):
        agents = build_agents(*a, **kw)
        for name, agent in agents.items():
            agent.np_rng = IdentityPermutation()

            def validate(*va, _name=name, _agent=agent,
                         _validate=agent.validate, **vkw):
                preds = _validate(*va, **vkw)
                captured[_name] = (preds, _agent, vkw["dataset"])
                return preds

            agent.validate = validate
        return agents
    return build


def phase_batched_eval(bpe, cfg, model, tmp):
    """Phase 38: run_training --mode test --no-streaming_eval (the agents'
    batched validate, batches of N_SLOTS) on the 7B-width runner: R2R over
    N_EPISODES episodes, EQA over BATCHED_EQA_EPISODES with the trie and the
    oracle pass; candidates in graph order. Gates: K1 once per layer of
    every navigation forward and generate call, no eval step, metrics
    finite, EQA's answers in the vocabulary, and the trajectories against
    validate_streaming's on the same weights and episodes under the
    near-tie rule. Returns the launches by task."""
    layers, feat = cfg.llm.num_layers, cfg.pano.image_feat_size
    runner = NavModelRunner(cfg, model, bpe, dims=slice_dims())
    build_agents = TTL.build_agents
    out = {}
    for task, n, yaml in (("R2R", N_EPISODES,
                           run_yaml("{image_feat_size: 1024, "
                                    "angle_feat_size: 4}")),
                          ("EQA", BATCHED_EQA_EPISODES,
                           RUN_GEN_YAML % {"len": MAX_ACTION_LEN})):
        root = f"{tmp}/batched_{task}"
        # run_training reads the train split's annotations in test mode too
        T.make_r2r_world(root, n_episodes=2, seed=10, split="train")
        T.make_r2r_world(root, n_episodes=n, seed=11, split="val")
        ycfg = load_yaml_text(yaml)
        args = TrainArgs(data_dir=root, output_dir=f"{root}/out",
                         mode="test", streaming_eval=False,
                         val_batch_size=N_SLOTS, test_datasets=[task],
                         seed=0)
        args.sync_from_config(ycfg)
        captured = {}
        TTL.build_agents = graph_order_agents(captured)
        try:
            torch.cuda.synchronize()
            zero_counters(runner)
            t0 = time.perf_counter()
            res = TTL.run_training(args, ycfg, feat_dbs={
                "mp3d": SyntheticImageFeaturesDB(feat)}, runner=runner)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            TTL.build_agents = build_agents
        launches = check_launches(38, runner, layers)
        calls = (runner.forward_calls, runner.generate_calls)
        if runner.eval_steps or runner.cached_steps \
                or not runner.forward_calls:
            raise RuntimeError(f"[38] {task}: the batched validate took "
                               f"another path: {runner.eval_steps} eval "
                               f"steps, {calls} forwards and generate calls")
        got, agent, ds = captured[task]
        timer = agent.timer.report()
        metrics = res[task]
        if len(got) != len(ds) or not all(math.isfinite(float(v))
                                          for v in metrics.values()):
            raise RuntimeError(f"[38] {task}: {len(got)} predictions for "
                               f"{len(ds)} episodes, metrics {metrics}")
        if task == "EQA":
            vocab = set(ds.answer_vocab)
            off = [p["instr_id"] for p in got if p["pred_answer"] not in
                   vocab or p["oracle_pred_answer"] not in vocab]
            if off:
                raise RuntimeError(f"[38] answers outside the vocabulary: "
                                   f"{off}")
        # the reference: streaming evaluation of the same episodes
        agent.np_rng = IdentityPermutation()
        with StepLogits(runner) as log, torch.inference_mode():
            want = agent.validate_streaming(
                task, dataclasses.replace(args, streaming_eval=True), ycfg,
                Dataloader(ds, N_SLOTS, shuffle=False), dataset=ds)
        g = {p["instr_id"]: p["trajectory"] for p in got}
        parted = near_tie_parts(38, g, {p["instr_id"]: p["trajectory"]
                                        for p in want}, log.logits)
        print(f"[38] {task} batched validation (--no-streaming_eval) of "
              f"{len(ds)} episodes in batches of {N_SLOTS} through "
              f"run_training in {dt:.3f} s: "
              f"{({k: round(float(v), 2) for k, v in metrics.items()})}; "
              f"{calls[0]} navigation forwards, {calls[1]} generate calls; "
              f"launches {launches} = {layers} x (forwards + generate "
              f"calls); trajectories against validate_streaming: "
              f"{len(g) - len(parted)} of {len(g)} equal, parted on "
              f"near-ties (instr_id, step, top-2 margin, limit): {parted}")
        print(f"[38] {timer}")
        out[task] = launches
    return out


def phase_hostmem(bpe, cfg, model, tmp):
    """Phase 39: a runner with device_memory=False (graph memory and
    history on the host: the panorama comes down, each step uploads the
    node and history embeddings) against the device-memory runner on the
    same weights, dropout off, candidates in graph order: one fused teacher
    batch of TRAIN_BATCH; one fused DAgger batch in one group, its actions
    forced to those the device-memory runner drew for it on the card; and
    streaming evaluation of HOSTMEM_EPISODES episodes. Gates: the same
    training trajectories, losses within DAGGER_AB_LOSS_REL, whole
    gradients within MIN_GRAD_COSINE, the evaluation's trajectories under
    the near-tie rule, K1-K3 as the path implies (no eval step on the host
    memory). Returns the host-memory runs' launches."""
    layers, feat = cfg.llm.num_layers, cfg.pano.image_feat_size
    args = perstep_args(cfg, dagger_streams=1)
    runners = {mem: perstep_runner(bpe, cfg, model, args, dropout=False,
                                   device_memory=mem == "device")
               for mem in ("device", "host")}
    anno = T.make_r2r_world(f"{tmp}/hostmem", n_episodes=TRAIN_BATCH,
                            seed=12, split="train")
    optim = T.train_config(MAX_ACTION_LEN).Optim
    launches = {k: 0 for k in COUNTERS}

    def run(mem, kind, forced=None):
        runner = runners[mem]
        agent, ds, _ = T.r2r_train(anno, runner, args, TRAIN_BATCH)
        agent.np_rng = IdentityPermutation()
        batch = next(iter(Dataloader(ds, TRAIN_BATCH, shuffle=False)))
        runner.zero_grads()
        zero_counters(runner)
        t = []
        if kind == "teacher":
            loss, traj = cuda_timed(FT.rollout_teacher_fused, t)(
                agent, args, "R2R", optim, batch, dataset=ds, train_ml=1.0)
        else:
            loss, traj = cuda_timed(FT.rollout_dagger_fused, t)(
                agent, args, "R2R", optim, batch, dataset=ds, train_ml=1.0,
                forced_actions=forced, np_rng=IdentityPermutation())
        got = check_launches(39, runner, layers)
        if mem == "host":
            if runner.eval_steps or runner.cached_steps:
                raise RuntimeError(f"[39] the host-memory {kind} took a "
                                   f"device-memory step")
            for k in launches:
                launches[k] += got[k]
        return float(loss), [x["path"] for x in traj], t[0], agent.timer

    # the actions the device-memory runner draws on the card
    steps_of = []
    loss_pass = FT._fused_trajectory_train

    def capture(agent, a, *, steps, **kw):
        steps_of.append(steps)
        return loss_pass(agent, a, steps=steps, **kw)

    FT._fused_trajectory_train = capture
    try:
        run("device", "dagger")
    finally:
        FT._fused_trajectory_train = loss_pass
    sampled, = steps_of
    forced = [s["actions"] for s in sampled]
    for kind in ("teacher", "dagger"):
        res = {}
        for mem in ("device", "host"):
            res[mem] = run(mem, kind, forced)
            if mem == "device":
                saved = grads_of(model)
        cos = grad_cosine(saved, model)
        del saved
        (ld, pd, td, _), (lh, ph, th, timer) = res["device"], res["host"]
        rel = abs(lh - ld) / abs(ld)
        print(f"[39] fused {kind} batch of {TRAIN_BATCH}, host memory "
              f"against device memory: {1e3 * th:.1f} against "
              f"{1e3 * td:.1f} ms; loss {lh:.6f} / {ld:.6f} (rel "
              f"{rel:.3e}); whole-gradient cosine {cos:.6f}")
        print(f"[39] {timer.report()}")
        if ph != pd:
            raise RuntimeError(f"[39] the host-memory {kind} took other "
                               f"trajectories")
        if not rel <= DAGGER_AB_LOSS_REL or not cos >= MIN_GRAD_COSINE:
            raise RuntimeError(f"[39] {kind}: loss rel {rel} (limit "
                               f"{DAGGER_AB_LOSS_REL}), gradient cosine "
                               f"{cos} (limit {MIN_GRAD_COSINE})")
    # streaming evaluation on both memories
    val = T.make_r2r_world(f"{tmp}/hostmem_val", n_episodes=HOSTMEM_EPISODES,
                           seed=13)
    preds, dts = {}, {}
    for mem in ("device", "host"):
        runner = runners[mem]
        agent, ds, eargs = T.r2r_eval(val, runner, N_SLOTS, feat)
        agent.np_rng = IdentityPermutation()
        zero_counters(runner)
        with StepLogits(runner) as log, torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = agent.validate_streaming(
                "R2R", eargs, T.eval_config(MAX_ACTION_LEN),
                Dataloader(ds, N_SLOTS, shuffle=False), dataset=ds)
            torch.cuda.synchronize()
            dts[mem] = time.perf_counter() - t0
        preds[mem] = {p["instr_id"]: p["trajectory"] for p in out}
        got = check_launches(39, runner, layers)
        if mem == "device":
            ref_log = log.logits
        else:
            for k in launches:
                launches[k] += got[k]
            n_steps = runner.forward_calls
            if runner.eval_steps:
                raise RuntimeError("[39] the host-memory evaluation took a "
                                   "device-memory step")
    parted = near_tie_parts(39, preds["host"], preds["device"], ref_log)
    print(f"[39] streaming eval of {HOSTMEM_EPISODES} episodes, host memory "
          f"(one slot group, {n_steps} steps) against device memory: "
          f"{1e3 * dts['host']:.1f} against {1e3 * dts['device']:.1f} ms; "
          f"trajectories {len(preds['host']) - len(parted)} of "
          f"{len(preds['host'])} equal, parted on near-ties (instr_id, step, "
          f"top-2 margin, limit): {parted}")
    print(f"[39] {agent.timer.report()}")
    return launches


def phase_eqa_train(bpe, cfg, model, tmp):
    """Phase 40: training on EQA batches of TRAIN_BATCH: one through the
    fused teacher, one through the per-step teacher rollout and one through
    the fused DAgger. Gates: each runs the answer head at its final step (a
    generation-loss grad call), the loss finite and below MAX_LOSS, K1-K3
    as the path implies (K2 and K3 once per layer of every grad call, the
    head's included). Returns the launches summed over the three."""
    from navillm_tpu_torch.agents import load_agent
    from navillm_tpu_torch.data.datasets import load_dataset
    from navillm_tpu_torch.sim import WorldModel
    layers, feat = cfg.llm.num_layers, cfg.pano.image_feat_size
    root = f"{tmp}/eqa_train"
    T.make_r2r_world(root, n_episodes=TRAIN_BATCH, seed=14, split="train")
    ycfg = load_yaml_text(RUN_GEN_YAML % {"len": MAX_ACTION_LEN})
    args = perstep_args(cfg, data_dir=root)
    args.sync_from_config(ycfg)
    runner = perstep_runner(bpe, cfg, model, args)
    world = WorldModel(f"{root}/connectivity")
    ds = load_dataset("eqa", args, ycfg, training=True, source="EQA",
                      world=world)
    ds.init_feat_db(SyntheticImageFeaturesDB(feat))
    agent = load_agent("eqa", args, world, runner)
    launches = {k: 0 for k in COUNTERS}
    for kind in ("fused teacher", "per-step teacher", "fused DAgger"):
        batch = next(iter(Dataloader(ds, TRAIN_BATCH, shuffle=False)))
        runner.zero_grads()
        zero_counters(runner)
        t = []
        if kind == "fused teacher":
            loss, _ = cuda_timed(FT.rollout_teacher_fused, t)(
                agent, args, "EQA", ycfg.Optim, batch, dataset=ds,
                train_ml=1.0)
        elif kind == "per-step teacher":
            loss, _ = cuda_timed(agent.rollout, t)(
                args, "EQA", ycfg.Optim, batch, dataset=ds,
                feedback="teacher", train_ml=1.0)
        else:
            loss, _ = cuda_timed(FT.rollout_dagger_fused, t)(
                agent, args, "EQA", ycfg.Optim, batch, dataset=ds,
                train_ml=1.0)
        got = check_launches(40, runner, layers)
        for k in launches:
            launches[k] += got[k]
        loss = float(loss)
        if runner.gen_grad_calls < 1 or not (math.isfinite(loss)
                                             and 0 < loss < MAX_LOSS):
            raise RuntimeError(f"[40] EQA {kind}: {runner.gen_grad_calls} "
                               f"answer-head calls, loss {loss}")
        print(f"[40] EQA {kind} batch of {TRAIN_BATCH}: {1e3 * t[0]:.1f} ms, "
              f"loss {loss:.4f}, {runner.grad_calls} grad calls "
              f"({runner.gen_grad_calls} of the answer head); launches {got}"
              f", per grad call {per_grad_call(got, runner.grad_calls)}")
    print(f"[40] {agent.timer.report()}")
    return launches


# ------------------------------------------- the pretrained path (33-35) --- #
class RSSPeak(contextlib.AbstractContextManager):
    """The process's resident set sampled every 20 ms while the block runs:
    ``peak_gib`` above ``base_gib`` (the RSS on entry)."""

    def __enter__(self):
        self.base_gib = self.peak_gib = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    @staticmethod
    def _rss() -> float:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 2 ** 30

    def _sample(self):
        while not self._stop.wait(0.02):
            self.peak_gib = max(self.peak_gib, self._rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_gib = max(self.peak_gib, self._rss())


def max_rss_gib() -> float:
    """resource.getrusage's peak RSS of the process so far."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def write_pretrained(cfg, model, vic):
    """Phase 33's checkpoint: the model's LLM as an HF-layout directory
    (models/convert.save_vicuna: config.json with the BPE's base vocabulary,
    ~5 GB safetensors shards and their index) with bpe_nav.json as its
    tokenizer.json. Returns (bytes, shards, seconds)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = save_vicuna(vic, model.llm, cfg.llm, vocab_rows=BPE_VOCAB,
                        shard_bytes=SHARD_BYTES)
    shutil.copy(Path(L.__file__).with_name("bpe_nav.json"),
                Path(vic) / "tokenizer.json")
    (Path(vic) / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "bos_token": "<s>",
        "eos_token": "</s>", "unk_token": "<unk>", "pad_token": "<PAD>",
        "clean_up_tokenization_spaces": False}))
    os.sync()
    dt = time.perf_counter() - t0
    return (index["metadata"]["total_size"],
            len(set(index["weight_map"].values())), dt)


def pretrained_yaml(root, feat):
    path = Path(root) / "r2r.yaml"
    path.write_text(run_yaml('{image_feat_size: %d, angle_feat_size: 4, '
                             'feature_database: {"mp3d": "features.hdf5"}}'
                             % feat))
    return str(path)


def phase_load(cfg, model, vic, tmp):
    """Phase 33: the model's LLM written as an HF-layout checkpoint, then
    read back through build_runner with the CLI's arguments
    (--pretrained_model_name_or_path, bf16, --enable_og) on the card. Gates:
    every loaded leaf equal to its source bit for bit (the embedding and
    lm_head rows past the checkpoint's vocabulary equal to the numpy-f32
    mean of its rows), the configuration equal to the source's but for the
    vocabulary, and one forward_navigation step on phase 4's inputs through
    K1 giving the source model's logits bit for bit. Returns K1's
    launches."""
    for p in model.parameters():       # earlier phases' gradients
        p.grad = None
    gc.collect()
    torch.cuda.empty_cache()
    nbytes, shards, write_s = write_pretrained(cfg, model, vic)
    args, ycfg = read_args([
        "--cfg_file", pretrained_yaml(tmp, cfg.pano.image_feat_size),
        "--output_dir", f"{tmp}/load", "--pretrained_model_name_or_path",
        vic, "--precision", "bf16", "--enable_og"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with RSSPeak() as rss:
        t0 = time.perf_counter()
        runner = TTL.build_runner(args, ycfg)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    dev_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    loaded = runner.model.llm
    if runner.device.type != model.llm["embed"].device.type or \
            runner.cfg.pano != cfg.pano or \
            dataclasses.replace(runner.cfg.llm, vocab_size=cfg.llm.vocab_size
                                ) != cfg.llm:
        raise RuntimeError(f"[33] build_runner built {runner.cfg} on "
                           f"{runner.device}, the source is {cfg}")
    V, V2 = BPE_VOCAB, runner.cfg.llm.vocab_size
    src = dict(model.llm.named_parameters())
    for name, got in loaded.named_parameters():
        want = src[name]
        if name in ("embed", "lm_head"):
            rows = want[:V] if name == "embed" else want[:, :V].t()
            # the mean over the rows as the file holds them ([V, H], C
            # order: numpy's summation order follows the layout)
            mean = torch.from_numpy(rows.detach().float().contiguous()
                                    .cpu().numpy().mean(axis=0))
            ext = got[V:] if name == "embed" else got[:, V:].t()
            got = got[:V] if name == "embed" else got[:, :V]
            want = want[:V] if name == "embed" else want[:, :V]
            if ext.shape[0] != V2 - V or not torch.equal(
                    ext, mean.to(ext)[None].expand_as(ext)):
                raise RuntimeError(f"[33] {name}'s rows {V}..{V2} are not "
                                   f"the numpy-f32 mean of its {V} rows")
        if got.dtype != want.dtype or not torch.equal(got, want):
            raise RuntimeError(f"[33] loaded {name} differs from its source")
    # one navigation step, source and loaded, on the same inputs
    vcfg = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, vocab_size=V))
    dev = ab_batch(vcfg)
    twin = NavModel(runner.cfg, {**{k: v for k, v in model.items()
                                    if k != "llm"}, "llm": loaded})
    flash_attention_fwd.launches = 0
    with torch.inference_mode():
        want = forward_navigation(model, cfg, dev)["fuse_logits"]
        got = forward_navigation(twin, runner.cfg, dev)["fuse_logits"]
    launches = flash_attention_fwd.launches
    if launches != 2 * cfg.llm.num_layers:
        raise RuntimeError(f"[33] K1 launches {launches} != 2 forwards x "
                           f"{cfg.llm.num_layers} layers")
    if not torch.isfinite(want).any() or not torch.equal(got, want):
        raise RuntimeError("[33] the loaded model's logits differ from the "
                           "source's")
    print(f"[33] HF-layout checkpoint of the 7B-width LLM ({nbytes / 1e9:.3f}"
          f" GB bf16 in {shards} safetensors shards of <= "
          f"{SHARD_BYTES / 1e9:.0f} GB, vocabulary {V}) written in "
          f"{write_s:.2f} s; loaded through build_runner (the CLI's "
          f"--pretrained_model_name_or_path, tokenizer.json read in plain "
          f"Python, vocabulary grown to {V2}) in {load_s:.2f} s: host RSS "
          f"{rss.base_gib:.2f} GiB before, {rss.peak_gib:.2f} GiB peak "
          f"during the load (+{rss.peak_gib - rss.base_gib:.2f} GiB; "
          f"getrusage's peak of the process so far {max_rss_gib():.2f} GiB);"
          f" device peak {dev_peak:.2f} GiB above the "
          f"{base / 2 ** 30:.2f} GiB already held; every leaf equal to its "
          f"source bit for bit, rows {V}..{V2 - 1} the numpy-f32 mean; "
          f"forward_navigation's {int((want > NEG_INF / 2).sum())} "
          f"candidate logits equal bit for bit through K1 ({launches} "
          f"launches)")
    del runner, twin, loaded
    gc.collect()
    torch.cuda.empty_cache()
    return {"fwd": launches, "dkv": 0, "dq": 0}


def spm_dir(vic, out, files) -> str:
    """A directory of symbolic links to the checkpoint files of ``vic``
    (config.json, the shards and their index) beside the fixture's
    ``files``: the same checkpoint with another tokenizer."""
    out = Path(out)
    out.mkdir()
    for f in Path(vic).iterdir():
        if not f.name.startswith("tokenizer"):
            (out / f.name).symlink_to(f)
    for f in files:
        shutil.copy(SPM_FIXTURE / f, out / f)
    return str(out)


def timed_tokenizer(path):
    """(NavTokenizer.from_pretrained(path), seconds)."""
    t0 = time.perf_counter()
    tok = NavTokenizer.from_pretrained(path)
    return tok, time.perf_counter() - t0


def encode_ms(tok, texts) -> float:
    """ms per text of the tokenizer's encode, over texts it has not
    encoded before (the encode caches of a fresh tokenizer)."""
    t0 = time.perf_counter()
    for t in texts:
        tok.backend.encode(t)
    return 1e3 * (time.perf_counter() - t0) / len(texts)


def phase_spm(cfg, vic, tmp):
    """Phase 33, continued: phase 33's checkpoint with LLaMA's sentencepiece
    tokenizer.model in place of its tokenizer.json (the committed fixture:
    BPE_VOCAB pieces, so the rows line up), read through build_runner with
    the CLI's arguments, and SPM_EPISODES R2R episodes of streaming
    evaluation from it; then the same model and evaluation with the
    tokenizer.json transformers converted from that model (the fixture's
    twin). Gates: the two tokenizers' special ids and sizes equal; every
    prompt of the run encoded to the same ids by both; trajectories and
    every step's logits equal bit for bit; K1 once per layer of every uncached
    step (phase 3's gate). Prints both routes' load seconds and encode ms per
    prompt, and a seeded SPM_VICUNA_PIECES-piece model's (Vicuna's size), read
    on the host. Returns (K1-K3 launches of the tokenizer.model run, its
    numbers)."""
    dirs = {"model": spm_dir(vic, f"{tmp}/spm_model", (
                "tokenizer.model", "tokenizer_config.json")),
            "json": spm_dir(vic, f"{tmp}/spm_json", (
                "tokenizer.json", "tokenizer_config.json"))}
    args, ycfg = read_args([
        "--cfg_file", pretrained_yaml(tmp, cfg.pano.image_feat_size),
        "--output_dir", f"{tmp}/spm_out", "--pretrained_model_name_or_path",
        dirs["model"], "--precision", "bf16"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = TTL.build_runner(args, ycfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    twin = NavModelRunner(runner.cfg, runner.model,
                          NavTokenizer.from_pretrained(dirs["json"]),
                          device=runner.device, feat_dropout=args.feat_dropout,
                          ignore_id=args.ignoreid, seed=args.seed,
                          kv_int8=args.kv_int8)
    bad = [a for a in TOK_ATTRS
           if getattr(runner.tok, a) != getattr(twin.tok, a)]
    if bad or runner.cfg.llm.vocab_size != runner.tok.vocab_size:
        raise RuntimeError(f"[33] tokenizer.model against tokenizer.json: "
                           f"{bad} differ; vocabulary "
                           f"{runner.cfg.llm.vocab_size}")
    runs = {}
    for key, r in (("model", runner), ("json", twin)):
        logits, prompts, step = [], [], r.eval_step

        def eval_step(*a, _step=step, _out=logits, **kw):
            res = _step(*a, **kw)
            _out.append(res[2].detach().clone())
            return res
        r.eval_step = eval_step
        trajs, stats = phase_slice(33, r.tok, r.cfg, r.model,
                                   f"{tmp}/spm_{key}_run", warm_up=False,
                                   prompts=prompts, runner=r,
                                   n_episodes=SPM_EPISODES)
        runs[key] = (trajs, stats, logits, prompts)
    (trajs, stats, logits, prompts), (trajs2, _, logits2, prompts2) = \
        runs["model"], runs["json"]
    same = len(logits) == len(logits2) and all(
        torch.equal(a, b) for a, b in zip(logits, logits2))
    if trajs != trajs2 or prompts != prompts2 or not same:
        raise RuntimeError(f"[33] the tokenizer.model run parts from the "
                           f"tokenizer.json twin's: trajectories equal "
                           f"{trajs == trajs2}, prompts equal "
                           f"{prompts == prompts2}, logits equal {same} "
                           f"({len(logits)} and {len(logits2)} steps)")
    # the host routes on the run's prompts, each tokenizer fresh
    texts = list(dict.fromkeys(prompts))
    tok_model, model_s = timed_tokenizer(dirs["model"])
    tok_json, json_s = timed_tokenizer(dirs["json"])
    model_ms, json_ms = encode_ms(tok_model, texts), encode_ms(tok_json, texts)
    ids = [tok_model.encode(t) for t in texts]
    if ids != [tok_json.encode(t) for t in texts]:
        raise RuntimeError("[33] the tokenizer.model encodes a prompt to "
                           "other ids than its tokenizer.json twin")
    big = Path(tmp) / "spm_vicuna"
    big.mkdir()
    t0 = time.perf_counter()
    T.write_sentencepiece_model(big / "tokenizer.model",
                                T.spm_pieces(SPM_VICUNA_PIECES))
    make_s = time.perf_counter() - t0
    shutil.copy(SPM_FIXTURE / "tokenizer_config.json", big)
    tok_big, big_s = timed_tokenizer(big)
    big_ms = encode_ms(tok_big, texts)
    if tok_big.true_vocab_size != SPM_VICUNA_PIECES + 6:
        raise RuntimeError(f"[33] the {SPM_VICUNA_PIECES}-piece model gives "
                           f"{tok_big.true_vocab_size} ids")
    if runner.device.type != "cuda":
        raise RuntimeError(f"[33] build_runner ran on {runner.device}")
    lengths = [len(x) for x in ids]
    print(f"[33] tokenizer.model (sentencepiece, {BPE_VOCAB} pieces) in "
          f"place of tokenizer.json: build_runner in {load_s:.2f} s, "
          f"{SPM_EPISODES} episodes, {stats['steps']} uncached steps at "
          f"{stats['ms_per_step']:.2f} ms; {len(prompts)} prompts "
          f"({len(texts)} distinct, {min(lengths)}-{max(lengths)} tokens) "
          f"encoded to the ids of transformers' tokenizer.json twin; "
          f"trajectories and {len(logits)} steps' logits equal bit for bit "
          f"to the twin's run; load {model_s * 1e3:.1f} ms (tokenizer.model) "
          f"against {json_s * 1e3:.1f} ms (tokenizer.json); encode "
          f"{model_ms:.3f} against {json_ms:.3f} ms per prompt; a "
          f"{SPM_VICUNA_PIECES}-piece model (written in {make_s:.2f} s): "
          f"load {big_s * 1e3:.1f} ms, encode {big_ms:.3f} ms per prompt; "
          f"launches {stats['launches']}")
    del runner, twin
    gc.collect()
    torch.cuda.empty_cache()
    return ({"fwd": stats["launches"], "dkv": 0, "dq": 0},
            {"build_runner_s": load_s, "model_load_s": model_s,
             "json_load_s": json_s, "model_encode_ms": model_ms,
             "json_encode_ms": json_ms, "vicuna_load_s": big_s,
             "vicuna_encode_ms": big_ms})


def moment_gate(w0):
    """8-bit Adam against exact f32 AdamW on one 7B layer slice (a trained
    w_gate[0], f32): MOMENT_STEPS steps of a noisy linear regression from
    it; tests/test_optim8.py's closeness bound on the final losses. Returns
    (initial, exact, 8-bit losses, ms per step exact and 8-bit)."""
    dev = w0.device
    g = torch.Generator(device=dev).manual_seed(0)
    h, o = w0.shape
    target = w0 + 0.02 * torch.randn((h, o), generator=g, device=dev)
    x = torch.randn((MOMENT_ROWS, h), generator=g, device=dev) \
        * (40.0 / h ** 0.5)
    y = x @ target

    def loss(w):
        return float(((x @ w - y) ** 2).mean())

    def run(moments_8bit):
        p = {"w": w0.clone()}
        opt = make_optimizer(p, lr=MOMENT_LR, grad_clip_norm=1e9,
                             moments_8bit=moments_8bit)
        times = []
        step = cuda_timed(opt.step, times)
        for _ in range(MOMENT_STEPS):
            r = x @ p["w"] - y
            step({"w": (2.0 / r.numel()) * (x.t() @ r)})
        return loss(p["w"]), 1e3 * sum(times[1:]) / (len(times) - 1)
    (exact, exact_ms), (q8, q8_ms) = run(False), run(True)
    first = loss(w0)
    if not (q8 <= max(exact * 1.10, exact + 1e-4) and q8 < 0.1 * first):
        raise RuntimeError(f"[34] 8-bit Adam on a 7B layer slice: loss "
                           f"{first:.4e} -> {q8:.4e}, exact AdamW "
                           f"{exact:.4e}")
    return first, exact, q8, exact_ms, q8_ms


def phase_pretrained_train(vic, tmp):
    """Phase 34: python -m navillm_tpu_torch.train's main() from the
    pretrained directory at stage multi, bf16, --adam_8bit: 4 batches of
    TRAIN_BATCH over phase 32's R2R world (gradient accumulation 2: 2
    optimizer steps; teacher and DAgger batches), validation and an
    epoch_0 checkpoint (the torch backend). Gates: losses finite and below
    MAX_LOSS, K1-K3 as the path implies, the 8-bit moments against exact
    AdamW on one trained layer slice (moment_gate). Then eval_r2r.sh's
    shape, --mode test --resume_from_checkpoint epoch_0 from the same
    directory: the resumed tree equal to the trained one bit for bit, K1
    once per layer of every step. Returns ({phase: launches}, the training
    peak in GiB)."""
    root = f"{tmp}/pre"
    T.make_r2r_world(root, n_episodes=4 * TRAIN_BATCH, seed=22,
                     split="train")
    T.make_r2r_world(root, n_episodes=PRETRAINED_VAL_EPISODES, seed=23,
                     split="val")
    common = ["--cfg_file", pretrained_yaml(root, 1024), "--data_dir", root,
              "--pretrained_model_name_or_path", vic, "--precision", "bf16",
              "--stage", "multi", "--val_batch_size", str(N_SLOTS)]
    rec = {"opt": [], "step_s": [], "batch_s": [], "losses": []}
    saved = (TTL.make_optimizer, R2RAgent.train)

    def make_opt(*a, **kw):
        tx = saved[0](*a, **kw)
        tx.step = cuda_timed(tx.step, rec["step_s"])
        rec["opt"].append(tx)
        return tx

    def train(self, name, *a, **kw):
        loss = cuda_timed(saved[1], rec["batch_s"])(self, name, *a, **kw)
        rec["losses"].append(float(loss))
        return loss
    TTL.make_optimizer, R2RAgent.train = make_opt, train
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        res, runner, (avg_loss, norms), names, dt = cli_main(common + [
            "--output_dir", f"{root}/out", "--adam_8bit", "--num_epochs",
            "1", "--num_steps_per_epoch", "4", "--batch_size",
            str(TRAIN_BATCH), "--gradient_accumulation_step", "2",
            "--fused_rows_per_call", str(ROWS_PER_CALL),
            "--max_saved_checkpoints", "1"])
    finally:
        TTL.make_optimizer, R2RAgent.train = saved
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    layers = runner.cfg.llm.num_layers
    launches = check_launches(34, runner, layers)
    tx, = rec["opt"]
    if not isinstance(tx, AdamQ8):
        raise RuntimeError(f"[34] --adam_8bit built {type(tx).__name__}")
    q8_bytes = tx.moment_bytes()
    scale_bytes = sum(t.numel() * t.element_size() for tree in (tx.ms, tx.vs)
                      for t in tree.values())
    adamw_bytes = 2 * sum(p.numel() * p.element_size()
                          for p in tx.params.values())
    norms = [float(n) for n in norms]
    losses = rec["losses"]
    if len(losses) != 4 or not all(math.isfinite(x) and 0 < x < MAX_LOSS
                                   for x in losses) \
            or len(norms) != 2 or not all(math.isfinite(n) and n > 0
                                          for n in norms) \
            or not runner.cached_steps or len(rec["step_s"]) != 2:
        raise RuntimeError(f"[34] losses {losses}, gradient norms {norms}, "
                           f"{runner.cached_steps} cached sampling steps, "
                           f"{len(rec['step_s'])} optimizer steps")
    r2r = res["R2R"]
    if not all(math.isfinite(r2r[k]) for k in ("sr", "spl")):
        raise RuntimeError(f"[34] SR/SPL not finite: {r2r}")
    w0 = runner.model.llm["layers"]["w_gate"][0].detach().float().clone()
    first, exact, q8, exact_ms, q8_ms = moment_gate(w0)
    del w0
    print(f"[34] main() from the pretrained directory (stage multi, bf16, "
          f"--adam_8bit, gradient accumulation 2) in {dt:.3f} s: batches "
          f"{names} in {[round(1e3 * s, 1) for s in rec['batch_s']]} ms, "
          f"losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 4) for x in norms]}; 8-bit optimizer step "
          f"{[round(1e3 * s, 1) for s in rec['step_s']]} ms; moments "
          f"{q8_bytes / 1e9:.3f} GB ({scale_bytes / 1e9:.3f} GB of f32 "
          f"scales) against AdamW's {adamw_bytes / 1e9:.3f} GB (bf16 m and "
          f"v); peak memory {peak:.2f} GiB; R2R "
          f"{({k: round(float(v), 2) for k, v in r2r.items()})}; "
          f"{runner.grad_calls} grad calls, {runner.cached_steps} cached "
          f"sampling steps; launches {launches}")
    print(f"[34] 8-bit moments on one 7B layer slice (w_gate[0], "
          f"{tuple(tx.params['llm.layers.w_gate'].shape[1:])} f32, "
          f"{MOMENT_STEPS} Adam steps of a linear regression): loss "
          f"{first:.4e} -> {q8:.4e}, exact AdamW {exact:.4e} (bound "
          f"{max(exact * 1.10, exact + 1e-4):.4e}); ms per step {q8_ms:.3f} "
          f"8-bit, {exact_ms:.3f} exact")
    # free the optimizer and the gradients before the second 7B tree
    del tx, rec["opt"][:]
    for p in runner.model.parameters():
        p.grad = None
    gc.collect()
    torch.cuda.empty_cache()
    res2, runner2, _, _, dt2 = cli_main(common + [
        "--output_dir", f"{root}/eval", "--mode", "test",
        "--resume_from_checkpoint", f"{root}/out/epoch_0"])
    resumed = check_launches(34, runner2, layers)
    trained = dict(runner.model.named_parameters())
    for name, p in runner2.model.named_parameters():
        if p.dtype != trained[name].dtype or not torch.equal(p,
                                                             trained[name]):
            raise RuntimeError(f"[34] resumed {name} differs from the "
                               f"trained one")
    if not runner2.eval_steps or runner2.grad_calls or \
            not all(math.isfinite(v) for v in res2["R2R"].values()):
        raise RuntimeError(f"[34] the resumed evaluation: "
                           f"{runner2.eval_steps} steps, "
                           f"{runner2.grad_calls} grad calls, {res2}")
    ckpt, = (p for p in Path(root, "out").glob("epoch_0.*")
             if p.suffix != ".json")
    print(f"[34] --mode test --resume_from_checkpoint epoch_0 ({ckpt.name}, "
          f"{ckpt.stat().st_size / 1e9:.3f} GB) "
          f"from the same directory in {dt2:.3f} s: the resumed tree equal "
          f"to the trained one bit for bit; {runner2.eval_steps} steps, "
          f"K1 {resumed['fwd']} = {runner2.eval_steps} x {layers}; R2R "
          f"{({k: round(float(v), 2) for k, v in res2['R2R'].items()})}")
    shutil.rmtree(f"{root}/out")
    del runner, runner2, trained
    gc.collect()
    torch.cuda.empty_cache()
    return {"34": launches, "34_resume": resumed}, peak


def phase_pretrained_int4(vic, tmp, tok, cfg, qmodel, w4):
    """Phase 35: --mode test --quantize_llm --quant_bits 4 from the
    pretrained directory (load_vicuna quantizes the loaded tree on the card
    with quantize_host_llama): K4 = 7 per layer of every LLM pass and K1 once
    per layer of it. The loaded int4 tree equals phase 9's (quantize_nav_params
    of the same weights, the CPU tests hold the two quantizers equal) byte
    for byte, on every row of the checkpoint's vocabulary; so phase 9's
    evaluation replayed on it (phase 9's tokenizer, panorama and heads)
    must give phase 9's trajectories. Returns ({phase: K1 launches},
    {phase: K4 launches})."""
    root = f"{tmp}/int4"
    T.make_r2r_world(root, n_episodes=PRETRAINED_VAL_EPISODES, seed=23,
                     split="val")
    T.make_r2r_world(root, n_episodes=N_SLOTS, seed=22, split="train")
    matmul_q4.launches = matmul_q4.int8_launches = 0
    res, runner, _, _, dt = cli_main([
        "--cfg_file", pretrained_yaml(root, 1024), "--data_dir", root,
        "--pretrained_model_name_or_path", vic, "--precision", "bf16",
        "--output_dir", f"{root}/out", "--mode", "test", "--quantize_llm",
        "--quant_bits", "4", "--val_batch_size", str(N_SLOTS)])
    layers = runner.cfg.llm.num_layers
    fwd = check_launches(35, runner, layers)
    passes = runner.eval_steps + runner.prefill_calls
    q4 = matmul_q4.launches
    if q4 != passes * layers * Q4_LAYER_MATMULS or not passes:
        raise RuntimeError(f"[35] K4 launches {q4} != {passes} LLM passes x "
                           f"{layers} x {Q4_LAYER_MATMULS}")
    got = dict(runner.model.llm.named_parameters())
    V = BPE_VOCAB
    for name, want in qmodel.llm.named_parameters():
        g = got[name]
        if name.startswith("embed."):
            g, want = g[:V], want[:V]
        elif name.startswith("lm_head."):
            g, want = g[..., :V], want[..., :V]
        if g.dtype != want.dtype or not torch.equal(g, want):
            raise RuntimeError(f"[35] the loaded int4 {name} differs from "
                               f"phase 9's")
    print(f"[35] --mode test --quantize_llm --quant_bits 4 from the "
          f"pretrained directory in {dt:.3f} s: K4 {q4} = {passes} LLM "
          f"passes x {layers} x {Q4_LAYER_MATMULS}, K1 {fwd['fwd']}; the "
          f"int4 tree (quantize_host_llama on the card) equal to phase 9's "
          f"(quantize_nav_params) byte for byte; R2R "
          f"{({k: round(float(v), 2) for k, v in res['R2R'].items()})}")
    cfg35 = dataclasses.replace(cfg, llm=runner.cfg.llm)
    replay = NavModel(cfg35, {**{k: v for k, v in qmodel.items()
                                 if k != "llm"}, "llm": runner.model.llm})
    del runner
    launches, trajs, _ = phase_q4_slice(35, tok, cfg35, replay, tmp, w4,
                                        warm_up=False, dense_tag=9)
    same = sum(trajs[k] == w4[k] for k in w4)
    if same != len(w4):
        raise RuntimeError(f"[35] {same} of {len(w4)} trajectories equal "
                           f"phase 9's")
    del replay
    gc.collect()
    torch.cuda.empty_cache()
    return {"35": fwd}, {"35": q4, "35_replay": launches}

# ------------------------------------------- the rest of quantization --- #
# phase 43's forced A/B: the W8A8 policy changes which actions are drawn,
# never the loss pass, so with the actions forced the loss may differ from
# the live policy's run only by the loss pass's own run-to-run rounding
# (the same bf16 ops on the same inputs; atomics in the backward)
SAMPLE_Q_LOSS_REL = 1e-3
# the quantization phases' episode counts (their run time is held to ~150
# s beside the others'): R2R episodes of phase 41, EQA episodes of 42,
# REVERIE and SOON episodes and CVDN dialogs of 44
W8A8_EPISODES = 16
EQA_A8_EPISODES = 8
INT4_OG_EPISODES = 8
INT4_CVDN_EPISODES = 8
# W8A8's int8 product on the card at the model's shapes: rows (a decode
# step's and lm_head's 4, padded; a navigation step's ~800) and weights
W8A8_ROWS = (4, 800)


def phase_sample_quant_ab(bpe, cfg, model, tmp):
    """Phase 43, continued: the card's twin of the JAX package's
    test_quant_sampling_policy. One DAgger batch of TRAIN_BATCH with
    dropout off, sampled on the W8A8 policy (cached), then its actions
    forced through sampling on the live weights and on the W8A8 policy:
    the same trajectories, losses within SAMPLE_Q_LOSS_REL and gradients
    within MIN_GRAD_COSINE."""
    nodrop = dataclasses.replace(cfg, pano=dataclasses.replace(
        cfg.pano, hidden_dropout_prob=0.0))
    args, runner = dagger_setup(bpe, nodrop, model)
    runner.feat_dropout = 0.0
    _, _, rollout = dagger_batch(tmp, args, runner)
    last = cfg.llm.num_layers - 1
    watch = {"llm.layers.wq[0]": lambda m: m.llm.layers.wq.grad[0],
             f"llm.layers.wq[{last}]": lambda m: m.llm.layers.wq.grad[last],
             "out_head.w": lambda m: m.out_head.w.grad,
             "pano.mapper.w": lambda m: m.pano.mapper.w.grad}
    groups, loss_pass = [], FT._fused_trajectory_train

    def capture(*a, **kw):
        groups.append(kw["steps"])
        return loss_pass(*a, **kw)

    def run(sample_quant, forced=None):
        runner.zero_grads()
        FT._fused_trajectory_train = capture
        try:
            loss, paths, t, counts = rollout(True, forced,
                                             dagger_sample_quant=sample_quant)
        finally:
            FT._fused_trajectory_train = loss_pass
        grads = {k: f(model).float().clone() for k, f in watch.items()}
        return float(loss), paths, grads, t

    sampled = run(True)
    n_steps = max(len(st) for st in groups)
    forced = [np.concatenate([st[t]["actions"] if t < len(st)
                              else np.zeros(len(st[0]["actions"]), np.int64)
                              for st in groups]) for t in range(n_steps)]
    live = run(False, forced)
    quant = run(True, forced)
    runner.take_grads()
    if not (sampled[1] == live[1] == quant[1]):
        raise RuntimeError("[43] the forced trajectories differ between the "
                           "live and the W8A8 sampling policy")
    rel = abs(quant[0] - live[0]) / abs(live[0])
    cos = {k: F.cosine_similarity(quant[2][k].flatten(),
                                  live[2][k].flatten(), dim=0).item()
           for k in watch}
    print(f"[43] one DAgger batch of {TRAIN_BATCH} (dropout off), sampled on "
          f"the W8A8 policy, then forced to its actions: trajectories equal "
          f"({n_steps} steps); loss W8A8-sampled {quant[0]:.6f} against "
          f"live-sampled {live[0]:.6f} (rel {rel:.3e}, limit "
          f"{SAMPLE_Q_LOSS_REL:.0e}); gradient cosine "
          f"{ {k: round(v, 6) for k, v in cos.items()} }; the batch took "
          f"{1e3 * quant[3]:.1f} ms against {1e3 * live[3]:.1f} ms")
    if not rel <= SAMPLE_Q_LOSS_REL or min(cos.values()) < MIN_GRAD_COSINE:
        raise RuntimeError("[43] the forced batch's loss pass differs between "
                           "the live and the W8A8 sampling policy")
    return {"rel": rel, "cos": min(cos.values())}


def phase_quantized_init(cfg):
    """Phase 41's tree: the navigation model with its LLM drawn already
    int8 on the card (init_nav_params(quantize_llm=True): each weight drawn,
    quantized and dropped before the next), against drawing the bf16 tree
    and quantizing it (quantize_nav_params): the two LLMs equal bit for
    bit, and each path's peak memory above what was allocated before it.
    Returns the int8 model."""
    def peak_of(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (torch.cuda.max_memory_allocated() - base) / 2 ** 30, \
            time.perf_counter() - t0

    def gen():
        return torch.Generator(device="cuda").manual_seed(0)

    model8, q_peak, q_s = peak_of(lambda: NavModel(cfg, init_nav_params(
        cfg, gen(), quantize_llm=True, quant_bits=8)))
    dense, d_peak, d_s = peak_of(lambda: quantize_nav_params(
        init_nav_params(cfg, gen()), 8))
    want, got = flatten_tree(dense["llm"]), flatten_tree(model8["llm"])
    same = sorted(want) == sorted(got) and all(
        torch.equal(want[k], got[k]) for k in want)
    del dense, want, got
    gc.collect()
    torch.cuda.empty_cache()
    llm_bytes = sum(p.numel() * p.element_size()
                    for p in model8.llm.parameters())
    print(f"[41] the int8 model drawn quantized on the card in {q_s:.2f} s, "
          f"peak {q_peak:.2f} GiB above the baseline, against bf16 init then "
          f"quantize_nav_params in {d_s:.2f} s, peak {d_peak:.2f} GiB; the "
          f"two LLMs equal bit for bit: {same}; LLM {llm_bytes / 1e9:.3f} GB "
          f"(layer matmuls, embed and lm_head int8)")
    if not same:
        raise RuntimeError("[41] init_nav_params(quantize_llm=True) differs "
                           "from quantizing the bf16 init")
    return model8


def check_w8a8_mm(llm):
    """W8A8 on int8 weights on the card (llama._mm -> int_mm ->
    torch._int_mm, rows below 17 padded) at W8A8_ROWS rows against the
    same function with the int8 product taken in f64 (exact): equal bit
    for bit, for wq, w_down and lm_head. Returns the padded calls."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    L.int_mm.padded_calls = L.int_mm.padded_rows = 0
    for name, w in (("wq", {k: v[0] for k, v in llm["layers"]["wq"].items()}),
                    ("w_down", {k: v[0] for k, v in
                                llm["layers"]["w_down"].items()}),
                    ("lm_head", dict(llm["lm_head"].items()))):
        for m in W8A8_ROWS:
            x = randn(gen, m, w["q"].shape[0])
            got = L._mm(x, w, a8=True)
            xq, sx = _act_q(x)
            exact = (xq.double() @ w["q"].double()).float()
            want = (exact * sx * w["s"].float()).to(x.dtype)
            if not torch.equal(got, want):
                raise RuntimeError(f"[41] W8A8 {name} at {m} rows differs "
                                   f"from its f64 product")
    return L.int_mm.padded_calls


def phase_w8a8(bpe, cfg, model8, tmp):
    """Phase 41: R2R streaming evaluation on int8 weights at the JAX
    bench's 7B headline: W8A8_EPISODES episodes in 2 slot groups of
    N_SLOTS on BPE prompts, weight-only int8 with a bf16 prefix cache (the
    reference, its step logits kept), W8A8 uncached
    (r2r_stream_7b_w8a8_bpe), then W8A8 with the prefix cache and the int8
    K/V (_cached_kv8). Gates: the int8 product exact (check_w8a8_mm);
    phase 13's and 14's (starts, metrics, K1 launches, cached path only);
    no K4 launch; the kv8 cached step against the uncached W8A8 step on
    one snapshot, and again on bf16 activations (phase_cached_ab, with its
    planted faults: K scaled to zero on bf16 activations only); and the
    near-tie rule with the int8 noise: every episode's first step sees
    the same state in both runs, so the largest logit deviation there (E0)
    is what the int8 noise does to a logit; where a kv8 trajectory parts
    from the reference's, the reference's top-2 margin at that step must
    be within 2 E0 and the bf16 limit. The three runs take the candidates
    in graph order, so that a trajectory depends only on its own states.
    The share of equal trajectories is printed (the CPU tests gate JAX's
    80%: with random 7B weights many steps are near-ties). Returns the
    measures."""
    a8 = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                          act_int8=True))
    padded = check_w8a8_mm(model8["llm"])
    logs, runs = {}, {}
    for name, c, kw in (("ref", cfg, dict(prefix_cache=True)),
                        ("a8", a8, {}),
                        ("kv8", a8, dict(prefix_cache=True, kv_int8=True,
                                         warm_up=False))):
        runner = NavModelRunner(c, model8, bpe, dims=slice_dims())
        lg = StepLogits(runner)        # around the measured run only
        runs[name] = phase_slice(41, bpe, c, model8, tmp, runner=runner,
                                 graph_order=True, window=lambda: lg,
                                 n_episodes=W8A8_EPISODES, **kw)
        logs[name] = lg.logits
    (ref, ref_st), (a8_trajs, a8_st), (kv_trajs, kv_st) = \
        runs["ref"], runs["a8"], runs["kv8"]

    def step0_dev(got, want):
        """The largest |dlogit| over the episodes' first steps, on the
        logits both runs hold valid."""
        return max((got[k] - want[k]).abs()[
            (want[k] > NEG_INF / 2) & (got[k] > NEG_INF / 2)].max().item()
            for k in want if k[1] == 0 and k in got)
    if any(st["q4_launches"] for st in (ref_st, a8_st, kv_st)):
        raise RuntimeError("[41] the int4 kernel ran on an int8 tree")
    same_kv = sum(kv_trajs[k] == ref[k] for k in ref)
    same_a8 = sum(a8_trajs[k] == ref[k] for k in ref)
    e0 = {k: step0_dev(logs[a], logs[b]) for k, (a, b) in
          {"W8A8": ("a8", "ref"), "kv8": ("kv8", "a8"),
           "both": ("kv8", "ref")}.items()}
    parted = near_tie_parts(41, kv_trajs, ref, logs["ref"], strict=False)
    ab = phase_cached_ab(bpe, a8, model8, tmp, tag=41, kv_int8=True)
    ab_kv8 = phase_cached_ab(bpe, cfg, model8, tmp, tag=41, kv_int8=True)
    beyond = [p for p in parted if p[2] > 2 * e0["both"] + p[3]]
    bf16_b = runner.prefix_cache_bytes(N_SLOTS, MAX_PREFIX)
    kv8_b = runner.prefix_cache_bytes(N_SLOTS, MAX_PREFIX, kv_int8=True)
    llm_b = sum(p.numel() * p.element_size() for p in model8.llm.parameters())

    def padded_per_step(st):
        calls, rows = st["int_mm_padded"]
        return (f"{calls / st['steps']:.1f} padded int8 products of "
                f"{rows / max(calls, 1):.1f} rows per step")
    print(f"[41] W8A8 on int8 weights: uncached {a8_st['ms_per_step']:.2f} ms "
          f"per step ({padded_per_step(a8_st)}), cached with the int8 K/V "
          f"{kv_st['ms_per_step']:.2f} ms per step "
          f"({padded_per_step(kv_st)}), "
          f"against weight-only int8 with a bf16 cache "
          f"{ref_st['ms_per_step']:.2f}; episodes/s {a8_st['episodes_per_s']:.3f}"
          f" / {kv_st['episodes_per_s']:.3f} / {ref_st['episodes_per_s']:.3f};"
          f" cache per slot group {kv8_b} bytes int8 against {bf16_b} bf16 "
          f"({kv8_b / bf16_b:.3f}x); LLM {llm_b / 1e9:.3f} GB; peak "
          f"{a8_st['peak_gib']:.2f} / {kv_st['peak_gib']:.2f} / "
          f"{ref_st['peak_gib']:.2f} GiB; trajectories equal to the "
          f"reference's: W8A8 uncached {same_a8}, W8A8 + kv8 {same_kv} of "
          f"{len(ref)}; where kv8 parts (instr_id, step, top-2 margin, the "
          f"bf16 limit): {parted}; first-step logit deviations E0: W8A8 "
          f"against weight-only {e0['W8A8']:.4f}, the int8 cache against "
          f"the bf16 one (both W8A8, cached against uncached) "
          f"{e0['kv8']:.4f}, both {e0['both']:.4f}; the int8 product exact "
          f"at {W8A8_ROWS} rows ({padded} of its calls padded)")
    if beyond:
        raise RuntimeError(f"[41] kv8 trajectories part on top-2 margins "
                           f"beyond 2 E0: {beyond}")
    return {"ref": ref_st, "a8": a8_st, "kv8": kv_st, "ab": ab,
            "ab_kv8": ab_kv8, "e0": e0,
            "same": (same_a8, same_kv), "cache_bytes": (bf16_b, kv8_b),
            "launches": sum(st["launches"] for st in (ref_st, a8_st, kv_st))}


def phase_eqa_w4a8(bpe, cfg, qmodel, tmp, ref):
    """Phase 42: the w4a8 generation that once raised (lm_head's W8A8
    product): phase 23's EQA evaluation (EQA_A8_EPISODES episodes) on the
    int4 tree with act_int8,
    with a bf16 and then an int8 prompt K/V (answers in the vocabulary; K4
    224 per LLM pass, decode steps included, all with int8 x); then the
    first decoded token's logits (the prefill's last position) and one
    decode step on the int8 prompt K/V, through K4 against
    q4_impl="plain", within logit_tol. Returns (the two runs' measures)."""
    a8 = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                          act_int8=True))
    # phase 25 warmed this tree up
    bf = phase_eqa(42, bpe, a8, qmodel, tmp, warm_up=False,
                   n_episodes=EQA_A8_EPISODES)
    kv = phase_eqa(42, bpe, a8, qmodel, tmp, warm_up=False, kv_int8=True,
                   n_episodes=EQA_A8_EPISODES)
    runner, ids, mask, inj_pos, inj_emb = gen_inputs(bpe, a8, qmodel, tmp)
    llm = qmodel["llm"]
    b_ids, b_mask, b_pos = D.bucket_prompt(ids, mask, inj_pos, bpe.pad_id)
    dev_mask = runner.upload(b_mask)
    out = {}
    with torch.inference_mode():
        for impl in ("auto", "plain"):
            c = dataclasses.replace(a8.llm, q4_impl=impl)
            logits, kv_ = D.prefill(llm, c, runner.upload(
                b_ids.astype(np.int64)), dev_mask, runner.upload(b_pos),
                inj_emb)
            first = logits.masked_fill(runner.special_mask, NEG_INF)
            tok0 = first.argmax(-1) if impl == "auto" else out["auto"][2]
            emb0 = L.embed_rows(llm["embed"], tok0)[:, None]
            h, _ = L.decode_step(llm, c, emb0, L.quantize_kv_stack(kv_), dev_mask,
                                 L.init_decode_cache(c, N_SLOTS, 1,
                                                     runner.device),
                                 0, dev_mask.sum(-1)[:, None])
            out[impl] = (first, L.logits_from_hidden(llm, c, h[:, 0],
                                                     runner.special_mask),
                         tok0)
    exc = [logit_excess(out["auto"][i], out["plain"][i]) for i in (0, 1)]
    print(f"[42] w4a8 generation: the first decoded token's logits through "
          f"K4 vs q4_impl=plain at {exc[0]:.3f} of the limit, one decode "
          f"step on the int8 prompt K/V at {exc[1]:.3f}; "
          f"{bf['ms_per_generate']:.1f} / {kv['ms_per_generate']:.1f} ms per "
          f"generate call (bf16 / int8 prompt K/V) and {bf['ms_per_decode']:.2f}"
          f" / {kv['ms_per_decode']:.2f} ms per decode token, beside phase "
          f"25's w4 {ref['ms_per_generate']:.1f} and {ref['ms_per_decode']:.2f};"
          f" {bf['ms_per_step']:.2f} / {kv['ms_per_step']:.2f} ms per nav "
          f"step; peak {bf['peak_gib']:.2f} / {kv['peak_gib']:.2f} GiB")
    if not max(exc) <= 1:
        raise RuntimeError(f"[42] w4a8 logits through K4 vs its plain version "
                           f"at {exc} of the limit")
    return bf, kv


def phase_int4_og_cvdn(bpe, cfg, qmodel, tmp):
    """Phase 44: the task mix on the int4 tree (w4): REVERIE and SOON
    (INT4_OG_EPISODES each, sampled at OG_TEMPERATURE, the OG queue) and
    CVDN (INT4_CVDN_EPISODES dialogs, the prefix cache with the int8 K/V,
    every cached step replayed through eval_step as phase 29 does, then
    timed), with phase 27's and 29's gates and K4 224 per LLM pass (OG
    calls and prefills included). Returns {name: measures}."""
    out = {}
    for task in ("REVERIE", "SOON"):
        out[task.lower()], _ = phase_og_eval(44, bpe, cfg, qmodel, tmp, task,
                                             n_episodes=INT4_OG_EPISODES)
    stop_b = qmodel.out_head.b
    with torch.no_grad():
        stop_b0 = stop_b[0].clone()
        stop_b[0] -= AB_STOP_SHIFT
    try:
        kw = dict(prefix_cache=True, kv_int8=True,
                  n_episodes=INT4_CVDN_EPISODES)
        out["cvdn_ab"], _ = phase_cvdn_eval(44, bpe, cfg, qmodel, tmp,
                                            ab=True, **kw)
        out["cvdn"], _ = phase_cvdn_eval(44, bpe, cfg, qmodel, tmp, **kw)
    finally:
        with torch.no_grad():
            stop_b[0] = stop_b0
    print(f"[44] the int4 tree: REVERIE {out['reverie']['ms_per_step']:.2f} "
          f"and SOON {out['soon']['ms_per_step']:.2f} ms per step, "
          f"{out['reverie']['ms_per_og']:.1f} / {out['soon']['ms_per_og']:.1f}"
          f" ms per OG call; CVDN cached with the int8 K/V "
          f"{out['cvdn']['ms_per_step']:.2f} ms per step, "
          f"{out['cvdn']['tokens_per_step']:.1f} LLM tokens per step; K4 "
          f"{sum(v['q4_launches'] for v in out.values())} launches in all")
    return out


# ------------------------------------------------- phases 45-47 (slice 14) --
# phase 45: the feature-extraction towers at full width, f32 (no TF32)
VIT_VIEWPOINTS = 8
VIT_VIEWS = 36
VIT_F64_IMAGES = 2
# f32 features against the f64 forward, and an image alone against its
# batch of 36, each held to this share of the largest |feature|: f32 has
# 2^-24 relative rounding, 24 pre-LN blocks of a few thousand-term sums
# leave ~1e-6 of the scale (5e-7 measured at the tiny width on the CPU)
VIT_REL = 1e-4
# the H100 SXM's published FP32 peak outside the tensor cores
PEAK_FP32 = 67e12
# phase 46: two ranks of tp=2 on the one card (gloo, CUDA tensors staged
# through host memory: NCCL refuses two ranks on one device); 4 episodes
# since phase 49 joined the run: a rank's step takes 1.1-1.5 s there,
# and 8 episodes left the whole run within 56 s of its 1200 s limit
TP_EPISODES = 4
# phase 47: dp=2 x tp=2 training at full width and 4 layers (four ranks
# of the full depth would not fit the card; 8 layers until phase 50 joined
# the run: its staged collectives grow with the depth, and on a slow host
# the whole run reached 1199.7 s of its 1200 s limit)
DP_TP_LAYERS = 4
DP_TP_EPISODES = 16
# the data group's mean loss against one card's on the concatenated batch:
# the split batch and the split heads regroup bf16 sums (each rounding
# 2^-8 relative), and the rows' losses are sums over the trajectory's
# steps; a wrong average or a missing rank moves it by a factor of 2
DP_TP_LOSS_REL = 2 ** -5
# the TP shards' int4 layer shapes (h, o) at 7B, tp=2: wq/wk/wv, w_gate/
# w_up split by column, wo and w_down by row
Q4_TP_SHAPES = ((4096, 2048), (4096, 5504), (2048, 4096), (5504, 4096))


def vit_flops(cfg) -> float:
    """Operations of one image's forward (2 per multiply-add): the patch
    embedding, and per block the q/k/v and out projections, scores and
    weighted values, the MLP (SwiGLU: three products)."""
    t, w, m = cfg.seq_len, cfg.width, cfg.mlp_dim
    patch = 2 * cfg.grid ** 2 * cfg.patch_size ** 2 * 3 * w
    attn = 2 * t * w * 4 * w + 2 * 2 * t * t * w
    mlp = (3 if cfg.style == "eva02" else 2) * 2 * t * w * m
    return patch + cfg.num_layers * (attn + mlp)


def vit_bound_ms(cfg, n: int, params) -> Tuple[float, str]:
    """n images: the weights and images read once, the features written
    once, the operations at the FP32 peak (the forward runs in f32 on the
    CUDA cores: TF32 is off)."""
    nbytes = 4 * (sum(t.numel() for t in flatten_tree(params).values())
                  + n * cfg.image_size ** 2 * 3 + n * cfg.width)
    return bound(n * vit_flops(cfg), nbytes, PEAK_FP32)


def _as_f64(tree):
    return {k: _as_f64(v) if isinstance(v, dict) else v.double()
            for k, v in tree.items()}


def phase_vision():
    """EVA02-CLIP-L-14-336 and CLIP ViT-L/14-336 with random f32 weights:
    FeatureExtractor's batched forward over VIT_VIEWPOINTS x 36 synthetic
    preprocessed views (images/s, peak memory, the FP32 bound), 2 images
    against the same forward in f64, and 2 images alone against their
    batch of 36."""
    out = {}
    for name, vcfg in (("EVA02-CLIP-L-14-336", ViTConfig.eva02_clip_l_14_336()),
                       ("CLIP ViT-L/14-336", ViTConfig.clip_l_14_336())):
        gen = torch.Generator(device="cuda").manual_seed(45)
        params = init_vit_params(vcfg, gen)             # on the card
        fe = FeatureExtractor(params, vcfg, batch_size=VIT_VIEWS)
        n = VIT_VIEWPOINTS * VIT_VIEWS
        imgs = torch.randn((n, vcfg.image_size, vcfg.image_size, 3),
                           generator=gen, device="cuda")
        fe.encode(imgs[:VIT_VIEWS])                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fe.forward_calls = 0
        t0 = time.perf_counter()
        feats = fe.encode(imgs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if feats.shape != (n, vcfg.width) or not np.isfinite(feats).all():
            raise RuntimeError(f"[45] {name}: features {feats.shape}, "
                               f"finite {np.isfinite(feats).all()}")
        if fe.forward_calls != VIT_VIEWPOINTS:
            raise RuntimeError(f"[45] {name}: {fe.forward_calls} forwards "
                               f"for {n} images in batches of {VIT_VIEWS}")
        with torch.inference_mode():
            ref = vit_forward_features(
                _as_f64(params), dataclasses.replace(vcfg, dtype=torch.float64),
                imgs[:VIT_F64_IMAGES].double()).cpu().numpy()
            solo = np.concatenate([vit_forward_features(
                params, vcfg, imgs[k:k + 1]).cpu().numpy()
                for k in (0, VIT_VIEWS // 2)])
        scale = np.abs(ref).max()
        f64_rel = np.abs(feats[:VIT_F64_IMAGES] - ref).max() / scale
        solo_rel = np.abs(solo - feats[[0, VIT_VIEWS // 2]]).max() / scale
        bound_ms, by = vit_bound_ms(vcfg, n, params)
        ips = n / dt
        print(f"[45] {name} (f32, {vcfg.num_layers} layers, width "
              f"{vcfg.width}, {vcfg.seq_len} tokens, random weights): {n} "
              f"images ({VIT_VIEWPOINTS} viewpoints x {VIT_VIEWS} views) in "
              f"{dt:.3f} s = {ips:.1f} images/s, {fe.forward_calls} forwards "
              f"of {VIT_VIEWS}; bound {bound_ms:.1f} ms ({by}, "
              f"{vit_flops(vcfg) / 1e12:.3f} TFLOP per image at "
              f"{PEAK_FP32 / 1e12:.0f} TFLOP/s FP32) = "
              f"{n / bound_ms * 1e3:.1f} images/s, {bound_ms / 1e3 / dt * 100:.1f}% "
              f"of it; peak memory {peak:.2f} GiB; f32 against f64 max "
              f"|d|/max|f| {f64_rel:.3e}; alone against the batch of "
              f"{VIT_VIEWS} {solo_rel:.3e}; MP3D's 10567 viewpoints x 36 "
              f"views would take {10567 * 36 / ips / 3600:.2f} h")
        if not (f64_rel <= VIT_REL and solo_rel <= VIT_REL):
            raise RuntimeError(f"[45] {name}: f64 {f64_rel:.3e}, alone "
                               f"{solo_rel:.3e} > {VIT_REL}")
        out[name] = {"images_per_s": ips, "bound_images_per_s":
                     n / bound_ms * 1e3, "peak_gib": peak,
                     "f64_rel": f64_rel, "solo_rel": solo_rel}
        del params, fe, imgs
        torch.cuda.empty_cache()
    return out


def _join(rank: int, dp: int, tp: int):
    """A rank spawned by testing.spawn_gloo (gloo over localhost, CUDA
    tensors staged through host memory): its grid on the shared card."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    plan = make_mesh(dp, tp, device="cuda:0")
    if rank == 0:
        print(f"[{46 if dp == 1 else 47}] {plan.describe()}", flush=True)
    return plan


def _tp_runs(tag, bpe, cfg, runner, tmp, warm: bool):
    """The uncached and the prefix-cached evaluation of TP_EPISODES
    episodes in graph order through ``runner``, each with phase_slice's
    gates (``warm``: a warm-up run first; the ranks skip it, their steps
    are bound by the staged collectives); returns {cached: (trajectories,
    stats)}."""
    out = {}
    for cached in (False, True):
        zero_counters(runner)
        out[cached] = phase_slice(tag, bpe, cfg, None, f"{tmp}/{int(cached)}",
                                  warm_up=warm and not cached,
                                  prefix_cache=cached, graph_order=True,
                                  n_episodes=TP_EPISODES, runner=runner)
    return out


def _tp_eval_rank(rank, tmp, ref_logits):
    plan = _join(rank, 1, 2)
    bpe = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    tmp = f"{tmp}/rank{rank}"
    res = {}
    for kind in ("bf16", "w4"):
        _, cfg, model = model_7b(tag=f"46 r{rank}", quiet=rank > 0)
        if kind == "w4":
            with torch.no_grad():
                model = NavModel(cfg, quantize_nav_params(model, bits=4))
        runner = NavModelRunner(cfg, model, bpe, dims=slice_dims(),
                                mesh_plan=plan)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        heads = L.local_heads(runner.model["llm"], cfg.llm)
        runs = _tp_runs(f"46 {kind} r{rank}", bpe, cfg, runner, tmp, False)
        q4 = {c: runs[c][1]["q4_launches"] for c in runs}
        if kind == "w4":
            for c, (_, st) in runs.items():
                passes = st["eval_steps"] + st["cached_steps"] \
                    + st["prefill_calls"]
                want = passes * cfg.llm.num_layers * Q4_LAYER_MATMULS
                if st["q4_launches"] != want:
                    raise RuntimeError(f"[46] r{rank} w4 K4 launches "
                                       f"{st['q4_launches']} != {want}")
        with torch.inference_mode():
            got = forward_navigation(runner.model, cfg,
                                     ab_batch(cfg))["fuse_logits"].cpu()
        excess = logit_excess(got, ref_logits[kind])
        if not excess <= 1.0:
            raise RuntimeError(f"[46] r{rank} {kind}: tp=2 logits against "
                               f"one card's exceed logit_tol x{excess:.3f}")
        res[kind] = {"trajs": {c: runs[c][0] for c in runs},
                     "stats": {c: runs[c][1] for c in runs},
                     "q4": q4, "excess": excess, "heads": heads,
                     "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                     "staged": plan.model.staged_calls}
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    if rank == 0:
        # K4 at the shards' shapes, each against its plain version
        res["q4_check"] = phase_q4_kernel(tag="46 r0", rows=(2048, 4),
                                          modes=("w4",),
                                          shapes=Q4_TP_SHAPES)
    return res


def phase_tp_eval(tmp):
    """tp=2 streaming evaluation at the full 7B: one card's runs on the
    same weights and episodes (graph order), then two ranks."""
    bpe = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    ref, ref_logits = {}, {}
    _, cfg, model = model_7b(tag=46)
    for kind in ("bf16", "w4"):
        if kind == "w4":
            with torch.no_grad():
                model = NavModel(cfg, quantize_nav_params(model, bits=4))
            gc.collect()
            torch.cuda.empty_cache()
        runner = NavModelRunner(cfg, model, bpe, dims=slice_dims())
        ref[kind] = _tp_runs(f"46 {kind} one card", bpe, cfg, runner,
                             f"{tmp}/one_{kind}", True)
        with torch.inference_mode():
            ref_logits[kind] = forward_navigation(
                model, cfg, ab_batch(cfg))["fuse_logits"].cpu()
        del runner
    del model
    gc.collect()
    torch.cuda.empty_cache()
    res = T.spawn_gloo(_tp_eval_rank, 2, tmp, ref_logits)
    for kind in ("bf16", "w4"):
        for cached in (False, True):
            one, st1 = ref[kind][cached]
            for r, rr in enumerate(res):
                got, st = rr[kind]["trajs"][cached], rr[kind]["stats"][cached]
                same = sum(got[k] == one[k] for k in one)
                print(f"[46] {kind} {'cached' if cached else 'uncached'} "
                      f"rank {r} ({rr[kind]['heads'][0]} of "
                      f"{cfg.llm.num_heads} heads): {same} of {len(one)} "
                      f"trajectories equal to one card's; "
                      f"{st['ms_per_step']:.1f} ms per step against "
                      f"{st1['ms_per_step']:.1f}; K1 {st['launches']}, K4 "
                      f"{st['q4_launches']}; peak {rr[kind]['peak_gib']:.2f}"
                      f" GiB; logits x{rr[kind]['excess']:.3f} of logit_tol;"
                      f" {rr[kind]['staged']} staged collectives")
            if res[0][kind]["trajs"][cached] != res[1][kind]["trajs"][cached]:
                raise RuntimeError(f"[46] {kind}: the two ranks' "
                                   f"trajectories differ")
    return res, ref


def model_dp_tp(seed: int = 47):
    """phase 47's model: 7B width, DP_TP_LAYERS layers, bf16, dropout off,
    from a seed; BPE prompts."""
    tok = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    llm = LlamaConfig.vicuna_7b(vocab_size=32128, max_seq_len=1024,
                                num_layers=DP_TP_LAYERS, dtype=torch.bfloat16)
    cfg = NavModelConfig(llm=llm, pano=PanoConfig(
        output_size=llm.hidden_size, dtype=torch.bfloat16,
        hidden_dropout_prob=0.0))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tok, cfg, NavModel(cfg, init_nav_params(cfg, gen))


def _train_epoch(tok, cfg, runner, root, batch, rank=0, world=1, tx=None):
    """Teacher forcing (stage pretrain, fused teacher, no dropout, graph
    order) of DP_TP_EPISODES episodes, batch episodes per rank and
    optimizer step. Returns (losses per batch, norms, seconds, tx)."""
    args = TrainArgs(stage="pretrain", image_feat_size=cfg.pano.image_feat_size,
                     fused_rows_per_call=ROWS_PER_CALL, feat_dropout=0.0,
                     gradient_accumulation_step=1, seed=0)
    dims = RolloutDims(max_gmap_nodes=48, max_views=44, max_cands=47,
                       max_hist=16)
    runner.dims = dims
    anno = T.make_r2r_world(root, n_episodes=DP_TP_EPISODES, seed=0,
                            split="train")
    world_model = WorldModel(str(Path(anno).parents[2] / "connectivity"))
    ds = R2RDataset(anno, world_model, training=True)
    ds.init_feat_db(SyntheticImageFeaturesDB(args.image_feat_size))
    loader = Dataloader(ds, batch, shuffle=False, rank=rank,
                        world_size=world)
    agent = R2RAgent(args, world_model, runner)
    agent.np_rng = IdentityPermutation()
    losses = []
    train = agent.train

    def recorded(*a, **kw):
        losses.append(train(*a, **kw))
        return losses[-1]
    agent.train = recorded
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, norms = train_one_epoch(args, T.train_config(MAX_ACTION_LEN), runner,
                               tx, make_opt_step(tx),
                               MetaLoader({"R2R": (loader, 1.0)}),
                               {"R2R": agent}, {"R2R": ds}, 0, None,
                               num_batches=len(loader))
    torch.cuda.synchronize()
    return ([float(x) for x in losses], [float(n) for n in norms],
            time.perf_counter() - t0)


def _dp_tp_rank(rank, tmp):
    plan = _join(rank, 2, 2)
    tok, cfg, model = model_dp_tp()
    runner = NavModelRunner(cfg, model, tok, feat_dropout=0.0,
                            seed=plan.dp_rank, mesh_plan=plan)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    named = dict(runner.model.named_parameters())
    tx = make_optimizer(named, lr=1e-5, grad_clip_norm=40.0)
    tx.set_plan(plan, runner.param_specs)
    replicated = tx.moment_bytes()
    zero1_shard_opt_state(tx, plan)
    torch.cuda.reset_peak_memory_stats()
    zero_counters(runner)
    losses, norms, dt = _train_epoch(tok, cfg, runner, f"{tmp}/rank{rank}",
                                     TRAIN_BATCH // plan.dp_size,
                                     plan.dp_rank, plan.dp_size, tx)
    launches = check_launches(f"47 r{rank}", runner, cfg.llm.num_layers)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the data group's members must hold the same parameters
    sums = [float(p.detach().double().sum()) for p in named.values()]
    group = all_gather_objects(sums, plan.data)
    if any(g != group[0] for g in group):
        raise RuntimeError(f"[47] r{rank}: parameters differ across the "
                           f"data group")
    merged = merge_dist_results(all_gather_objects(
        [{"rank": rank, "losses": losses}]))
    return {"losses": losses, "norms": norms, "seconds": dt,
            "launches": launches, "peak_gib": peak,
            "moment_bytes": tx.moment_bytes(), "replicated_bytes": replicated,
            "merged": merged, "dp_rank": plan.dp_rank,
            "staged": plan.model.staged_calls + plan.data.staged_calls,
            "grad_calls": runner.grad_calls}


def phase_dp_tp_train(tmp):
    """dp=2 x tp=2 training (ZeRO-1, AdamW) at full width and DP_TP_LAYERS
    layers, two
    optimizer steps, against one card's steps on the same batches."""
    tok, cfg, model = model_dp_tp()
    runner = NavModelRunner(cfg, model, tok, feat_dropout=0.0, seed=0)
    tx = make_optimizer(dict(model.named_parameters()), lr=1e-5,
                        grad_clip_norm=40.0)
    torch.cuda.reset_peak_memory_stats()
    one_losses, one_norms, one_dt = _train_epoch(tok, cfg, runner,
                                                 f"{tmp}/one", TRAIN_BATCH,
                                                 tx=tx)
    one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = sum(p.numel() for p in model.parameters())
    del runner, model, tx
    gc.collect()
    torch.cuda.empty_cache()
    res = T.spawn_gloo(_dp_tp_rank, 4, tmp)
    by_dp = {r["dp_rank"]: r for r in res}
    losses = [sum(by_dp[d]["losses"][i] for d in by_dp) / len(by_dp)
              for i in range(len(one_losses))]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, one_losses))
    for r, rr in enumerate(res):
        print(f"[47] rank {r} (dp {rr['dp_rank']}): losses "
              f"{[round(x, 4) for x in rr['losses']]}, grad norms "
              f"{[round(x, 4) for x in rr['norms']]}; "
              f"{1e3 * rr['seconds'] / len(rr['norms']):.0f} ms per "
              f"optimizer step; {rr['grad_calls']} grad calls, launches "
              f"{rr['launches']}; peak {rr['peak_gib']:.2f} GiB; moments "
              f"{rr['moment_bytes'] / 2 ** 30:.2f} GiB (ZeRO-1) against "
              f"{rr['replicated_bytes'] / 2 ** 30:.2f} GiB replicated; "
              f"{rr['staged']} staged collectives")
    print(f"[47] {n / 1e9:.3f} B params, {DP_TP_LAYERS} layers: data-group "
          f"mean losses {[round(x, 4) for x in losses]} against one card's "
          f"{[round(x, 4) for x in one_losses]} on the concatenated "
          f"batches (max rel {rel:.2e}); one card "
          f"{1e3 * one_dt / len(one_norms):.0f} ms per optimizer step, "
          f"peak {one_peak:.2f} GiB; grad norms {[round(x, 4) for x in one_norms]}"
          f"; merged over 4 ranks: {[m['rank'] for m in res[0]['merged']]}")
    if not rel <= DP_TP_LOSS_REL:
        raise RuntimeError(f"[47] dp x tp losses part from one card's by "
                           f"{rel:.3e} > {DP_TP_LOSS_REL}")
    if len(res[0]["merged"]) != 4 or any(
            r["moment_bytes"] >= 0.75 * r["replicated_bytes"] for r in res):
        raise RuntimeError("[47] merge or ZeRO-1 moment bytes")
    return res


# Phase 48: the feature prefetcher (data/prefetch.py) on the fused teacher
# and DAgger, over a disk-backed store: with it, held off, held off, with it
# (the repeat in reverse cancels the host's drift). Depth cut since phase 50
# joined the run, whose first whole run took 1199.7 s of the 1200 s limit
# on a slow host: one teacher and one DAgger batch per run (were two of
# each) and 16 eval episodes per run (were N_EPISODES)
PREFETCH_BATCHES = 2        # stage multi: teacher, DAgger
PREFETCH_EVAL_EPISODES = 16
PREFETCH_RUNS = (True, False, False, True)


def phase_prefetch(bpe, cfg, model, tmp, smi):
    """Phase 48: PREFETCH_BATCHES batches of TRAIN_BATCH through agent.train
    at stage multi (the fused teacher on even steps, the fused DAgger with
    cached sampling on odd ones; remat, BPE) over testing.NpyFeaturesDB, one
    .npy file of [36, 1024] f32 per viewpoint read as ImageFeaturesDB reads
    (cache=False: only the prefetcher fills the cache). No optimizer step,
    and each run builds its runner and agent from the same seed, so the
    runs compute the same numbers; the runs in PREFETCH_RUNS' order are
    with the agent's prefetcher and with it held off
    (testing.hold_off_prefetch). Gates: every run's losses equal bit for
    bit, finite gradients with a norm > 0, K1/K2/K3 launches as phase 18's
    path implies and the same in every run, and get_obs reads that hit the
    cache only where the prefetcher filled it. Prints ms per batch, the
    pano_assemble and get_obs ms per call both ways, the keys prefetched
    and the hit share of the rollouts' get_obs reads. Returns the first
    run's launches."""
    anno = T.make_r2r_world(f"{tmp}/world", seed=0, split="train",
                            n_episodes=PREFETCH_BATCHES * TRAIN_BATCH)
    feat = cfg.pano.image_feat_size
    root = T.write_npy_features(f"{tmp}/features", f"{tmp}/world/connectivity",
                                feat)
    config = T.train_config(MAX_ACTION_LEN)
    layers = cfg.llm.num_layers
    t_phase = time.perf_counter()
    runs = []
    for prefetch in PREFETCH_RUNS:
        args, runner = dagger_setup(bpe, cfg, model)
        agent, ds, loader = T.r2r_train(anno, runner, args, TRAIN_BATCH)
        db = T.NpyFeaturesDB(root, feat)
        ds.init_feat_db(db)
        if not prefetch:
            T.hold_off_prefetch(agent)
        runner.zero_grads()
        torch.cuda.synchronize()
        zero_counters(runner)
        losses, batch_ms, reads, hits = [], [], 0, 0
        batches = iter(loader)
        for step in range(PREFETCH_BATCHES):
            batch = next(batches)
            r0, h0 = db.reads, db.hits
            t0 = time.perf_counter()
            losses.append(agent.train("R2R", batch, args, config, ds,
                                      step=step))
            torch.cuda.synchronize()
            batch_ms.append(1e3 * (time.perf_counter() - t0))
            reads += db.reads - r0
            hits += db.hits - h0
        launches = check_launches(48, runner, layers)
        norm = torch.stack([torch.linalg.vector_norm(p.grad,
                                                     dtype=torch.float32)
                            for p in model.parameters()]).norm()
        if not (torch.isfinite(norm) and norm > 0):
            raise RuntimeError(f"[48] gradient norm {float(norm)}")
        agent._prefetcher.drain()
        stages = agent.timer.summary()
        runs.append({"prefetch": prefetch, "losses": torch.stack(losses),
                     "batch_ms": batch_ms, "reads": reads, "hits": hits,
                     "keys": len(db._store), "launches": launches,
                     **{k: stages[k]["mean_ms"] for k in ("pano_assemble",
                                                          "get_obs")}})
        print(f"[48] prefetch {'on' if prefetch else 'held off'}: batches "
              f"{[round(x, 1) for x in batch_ms]} ms (teacher, DAgger); "
              f"pano_assemble "
              f"{stages['pano_assemble']['mean_ms']:.3f} ms x "
              f"{stages['pano_assemble']['count']}, get_obs "
              f"{stages['get_obs']['mean_ms']:.3f} ms x "
              f"{stages['get_obs']['count']}; {hits} of {reads} rollout "
              f"get_obs reads hit the cache; {len(db._store)} keys "
              f"prefetched; losses {[float(x) for x in losses]}; grad norm "
              f"{float(norm):.4f}; launches {launches}")
        del agent, ds, loader, runner, batches, batch
        gc.collect()
        torch.cuda.empty_cache()
    model.zero_grad(set_to_none=True)
    ref = runs[0]
    for r in runs[1:]:
        if not torch.equal(r["losses"], ref["losses"]):
            raise RuntimeError(f"[48] losses {r['losses'].tolist()} (prefetch "
                               f"{r['prefetch']}) != {ref['losses'].tolist()}")
        if r["launches"] != ref["launches"]:
            raise RuntimeError(f"[48] launches {r['launches']} != "
                               f"{ref['launches']}")
    for r in runs:
        cached = (r["hits"] > 0 and r["keys"] > 0) if r["prefetch"] \
            else (r["hits"] == 0 and r["keys"] == 0)
        if not cached:
            raise RuntimeError(f"[48] prefetch {r['prefetch']}: {r['hits']} "
                               f"hits, {r['keys']} keys cached")

    def mean(key, on):
        vals = [r[key] for r in runs if r["prefetch"] == on]
        return sum(vals) / len(vals)

    def per_kind(on, kind):
        return [round(r["batch_ms"][i], 1) for r in runs
                if r["prefetch"] == on for i in range(kind, PREFETCH_BATCHES,
                                                       2)]

    on = [r for r in runs if r["prefetch"]]
    print(f"[48] {smi}: training, with the prefetcher against held off, "
          f"pano_assemble "
          f"{mean('pano_assemble', True):.3f} against "
          f"{mean('pano_assemble', False):.3f} ms per call, get_obs "
          f"{mean('get_obs', True):.3f} against {mean('get_obs', False):.3f}"
          f" ms per call; teacher batches {per_kind(True, 0)} against "
          f"{per_kind(False, 0)} ms, DAgger batches {per_kind(True, 1)} "
          f"against {per_kind(False, 1)} ms; hit share of the rollouts' "
          f"get_obs reads {sum(r['hits'] for r in on)} of "
          f"{sum(r['reads'] for r in on)}, {on[0]['keys']} keys prefetched "
          f"per run; losses equal bit for bit over {len(runs)} runs")
    evals = prefetch_evals(bpe, cfg, model, tmp, root, smi)
    print(f"[48] phase {time.perf_counter() - t_phase:.1f} s")
    return ref["launches"], evals


def prefetch_evals(bpe, cfg, model, tmp, root, smi):
    """Phase 48's streaming evaluation: PREFETCH_EVAL_EPISODES greedy R2R
    episodes on BPE prompts (phase 13's path) over the .npy store and over
    the synthetic store (no cache: the pool's reads are thrown away), each
    in PREFETCH_RUNS' order. Gates: the same trajectories in every run (the
    two stores hold the same values), K1 once per layer of every step,
    cache hits only where the prefetcher ran on the .npy store. Returns the
    first run's K1 launches."""
    anno = T.make_r2r_world(f"{tmp}/eval", n_episodes=PREFETCH_EVAL_EPISODES)
    feat = cfg.pano.image_feat_size
    layers = cfg.llm.num_layers
    runs = []
    for store in ("npy", "synthetic"):
        for prefetch in PREFETCH_RUNS:
            runner = NavModelRunner(cfg, model, bpe, dims=slice_dims())
            agent, ds, args = T.r2r_eval(anno, runner, N_SLOTS, feat)
            db = T.NpyFeaturesDB(root, feat) if store == "npy" else None
            if db is not None:
                ds.init_feat_db(db)
            if not prefetch:
                T.hold_off_prefetch(agent)
            torch.cuda.synchronize()
            zero_counters(runner)
            t0 = time.perf_counter()
            preds = run_eval(agent, ds, args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            steps = runner.eval_steps
            if flash_attention_fwd.launches != steps * layers:
                raise RuntimeError(f"[48] eval K1 launches "
                                   f"{flash_attention_fwd.launches} != "
                                   f"{steps} steps x {layers}")
            agent._prefetcher.drain()
            st = agent.timer.summary()
            r = {"store": store, "prefetch": prefetch,
                 "trajs": {p["instr_id"]: p["trajectory"] for p in preds},
                 "ms_per_step": 1e3 * dt / steps, "steps": steps,
                 "launches": flash_attention_fwd.launches,
                 "hits": db.hits if db else 0, "reads": db.reads if db else 0,
                 "keys": len(db._store) if db else 0,
                 **{k: st[k]["mean_ms"] for k in ("pano_assemble",
                                                  "get_obs")}}
            runs.append(r)
            print(f"[48] eval, {store} store, prefetch "
                  f"{'on' if prefetch else 'held off'}: {len(preds)} "
                  f"episodes, {steps} steps, {r['ms_per_step']:.2f} ms wall "
                  f"per step; pano_assemble {r['pano_assemble']:.3f} ms, "
                  f"get_obs {r['get_obs']:.3f} ms per call; {r['hits']} of "
                  f"{r['reads']} store reads hit the cache, {r['keys']} "
                  f"keys")
            del agent, ds, runner
    for r in runs:
        if r["trajs"] != runs[0]["trajs"] or r["steps"] != runs[0]["steps"]:
            raise RuntimeError(f"[48] eval trajectories of the {r['store']} "
                               f"store, prefetch {r['prefetch']}, differ")
        hit = r["hits"] > 0 and r["keys"] > 0
        if hit != (r["store"] == "npy" and r["prefetch"]):
            raise RuntimeError(f"[48] eval {r['store']}, prefetch "
                               f"{r['prefetch']}: {r['hits']} hits, "
                               f"{r['keys']} keys")

    def ms(store, on, key="ms_per_step"):
        return [round(r[key], 2) for r in runs
                if r["store"] == store and r["prefetch"] == on]

    for store in ("npy", "synthetic"):
        print(f"[48] {smi}: eval over the {store} store, with the prefetcher "
              f"against held off: {ms(store, True)} against "
              f"{ms(store, False)} ms wall per step; get_obs "
              f"{ms(store, True, 'get_obs')} against "
              f"{ms(store, False, 'get_obs')} ms, pano_assemble "
              f"{ms(store, True, 'pano_assemble')} against "
              f"{ms(store, False, 'pano_assemble')} ms per call")
    return runs[0]["launches"]


# ---------------------------------------- slice 19: the HDF5 feature files --- #
HDF5_FIXTURE = Path(__file__).resolve().parent / "tests/fixtures/hdf5"
# MP3D's viewpoints: the keys of one view-feature file
MP3D_VIEWPOINTS = 10567
HDF5_EVA_VIEWPOINTS = 2


def same_bits(got, want) -> bool:
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape \
        and got.tobytes() == want.tobytes()


def phase_hdf5_fixture():
    """Phase 50 (a): the committed files h5py made
    (scripts/data_tools/make_hdf5_fixture.py) read by the port's reader:
    every dataset equal to its .npz twin bit for bit."""
    for name in ("extractor", "layouts", "many_keys"):
        t0 = time.perf_counter()
        with hdf5.File(HDF5_FIXTURE / f"{name}.h5") as f, \
                np.load(HDF5_FIXTURE / f"{name}.npz") as z:
            open_ms = 1e3 * (time.perf_counter() - t0)
            bad = [k for k in z.files if not same_bits(f[k][...], z[k])]
            if bad or not z.files:
                raise RuntimeError(f"[50] {name}.h5: {bad} differ from "
                                   f"{name}.npz")
            print(f"[50] fixture {name}.h5: {len(z.files)} datasets equal "
                  f"to {name}.npz bit for bit; {len(f.keys())} root keys "
                  f"opened and indexed in {open_ms:.2f} ms")


def phase_hdf5_io(tmp, feat, smi):
    """Phase 50 (b)'s file: the eval world's viewpoints written by
    testing.write_hdf5_features ([36, feat] f32, SyntheticImageFeaturesDB's
    values, the extractors' layout), then the reader's and writer's times
    on the host: open and index, one [36, feat] read, write MB/s, and the
    index of a file of MP3D_VIEWPOINTS keys. Gates: every dataset reads
    back bit for bit, in h5py's chunk shape. Returns (annotations, the
    file's path)."""
    anno = T.make_r2r_world(f"{tmp}/eval", n_episodes=N_EPISODES)
    conn = f"{tmp}/eval/connectivity"
    path = Path(f"{tmp}/eval/features.hdf5")
    T.write_hdf5_features(path, conn, feat)
    views = list(T.world_features(conn, feat))
    t0 = time.perf_counter()
    with hdf5.File(f"{tmp}/rewrite.hdf5", "w") as f:
        for key, arr in views:
            write_features(f, key, arr)
    write_s = time.perf_counter() - t0
    raw_mb = sum(a.nbytes for _, a in views) / 1e6
    t0 = time.perf_counter()
    f = hdf5.File(path)
    open_ms = 1e3 * (time.perf_counter() - t0)
    chunks = hdf5.guess_chunk((NUM_VIEWS, feat), 4)
    t0 = time.perf_counter()
    got = [(key, f[key]) for key, _ in views]
    arrays = [d[...] for _, d in got]
    read_ms = 1e3 * (time.perf_counter() - t0) / len(views)
    f.close()
    bad = [key for (key, want), a in zip(views, arrays)
           if not same_bits(a, want)]
    layouts = {(d.chunks, d.compression, d.compression_opts) for _, d in got}
    if bad or layouts != {(chunks, "gzip", hdf5.DEFAULT_GZIP)}:
        raise RuntimeError(f"[50] {bad} do not read back; layouts {layouts}")
    n_chunks = math.prod(-(-s // c) for s, c in zip((NUM_VIEWS, feat),
                                                     chunks))
    with hdf5.File(f"{tmp}/mp3d_keys.hdf5", "w") as w:
        for k in range(MP3D_VIEWPOINTS):
            w[f"scan{k % 90:02d}_{k * 2654435761 % 2 ** 32:08x}{k:024x}"] = \
                np.array([k], np.int32)
    t0 = time.perf_counter()
    with hdf5.File(f"{tmp}/mp3d_keys.hdf5") as big:
        index_ms = 1e3 * (time.perf_counter() - t0)
        if len(big.keys()) != MP3D_VIEWPOINTS:
            raise RuntimeError(f"[50] {len(big.keys())} keys")
    print(f"[50] {smi}, on the host: {len(views)} viewpoints [{NUM_VIEWS}, "
          f"{feat}] f32 written in the extractors' layout (chunks {chunks}, "
          f"{n_chunks} gzip chunks each, level {hdf5.DEFAULT_GZIP}) at "
          f"{raw_mb / write_s:.1f} MB/s of features ({raw_mb:.2f} MB, "
          f"{path.stat().st_size / 1e6:.2f} MB on disk); open and index "
          f"{open_ms:.3f} ms; {read_ms:.3f} ms per [{NUM_VIEWS}, {feat}] "
          f"read, every one bit for bit; an index of {MP3D_VIEWPOINTS} "
          f"keys opened in {index_ms:.1f} ms")
    return anno, path


def phase_hdf5_eval(bpe, cfg, model, anno, path, smi):
    """Phase 50 (b): phase 13's greedy streaming evaluation (N_EPISODES
    R2R episodes, BPE, the prefetcher on) over create_feature_db's
    ImageFeaturesDB on the HDF5 file, then over the synthetic store of the
    same values, with the same weights. Gates: trajectories and every
    step's logits equal bit for bit, K1 once per layer of every step, the
    file's store filled by the prefetcher. Returns the HDF5 run's K1
    launches."""
    feat = cfg.pano.image_feat_size
    layers = cfg.llm.num_layers
    runs = {}
    for store in ("hdf5", "synthetic"):
        runner = NavModelRunner(cfg, model, bpe, dims=slice_dims())
        agent, ds, args = T.r2r_eval(anno, runner, N_SLOTS, feat)
        db = None
        if store == "hdf5":
            db = create_feature_db({"mp3d": path.name}, feat,
                                   str(path.parent))["mp3d"]
            ds.init_feat_db(db)
        torch.cuda.synchronize()
        zero_counters(runner)
        with StepLogits(runner) as log:
            t0 = time.perf_counter()
            preds = run_eval(agent, ds, args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        steps = runner.eval_steps
        if not steps or flash_attention_fwd.launches != steps * layers:
            raise RuntimeError(f"[50] K1 launches "
                               f"{flash_attention_fwd.launches} != {steps} "
                               f"steps x {layers}")
        agent._prefetcher.drain()
        st = agent.timer.summary()
        runs[store] = {
            "trajs": {p["instr_id"]: p["trajectory"] for p in preds},
            "logits": log.logits, "steps": steps, "ms": 1e3 * dt / steps,
            "launches": flash_attention_fwd.launches,
            "keys": len(db._store) if db is not None else 0,
            "file": db is not None and isinstance(db._h5, hdf5.FileReader),
            **{k: st[k]["mean_ms"] for k in ("get_obs", "pano_assemble")}}
        r = runs[store]
        print(f"[50] eval over the {store} store: {len(preds)} episodes, "
              f"{steps} steps, {r['ms']:.2f} ms wall per step; get_obs "
              f"{r['get_obs']:.3f} ms, pano_assemble "
              f"{r['pano_assemble']:.3f} ms per call; {r['keys']} keys "
              f"prefetched; K1 launches {r['launches']} = {steps} x "
              f"{layers}")
        del agent, ds, runner, db
    h, s = runs["hdf5"], runs["synthetic"]
    if h["trajs"] != s["trajs"] or h["steps"] != s["steps"]:
        raise RuntimeError("[50] trajectories over the HDF5 file differ "
                           "from the synthetic store's")
    if h["logits"].keys() != s["logits"].keys() or not all(
            torch.equal(h["logits"][k], s["logits"][k]) for k in h["logits"]):
        raise RuntimeError("[50] step logits over the HDF5 file differ from "
                           "the synthetic store's")
    if not (h["file"] and h["keys"]):
        raise RuntimeError(f"[50] the HDF5 store read nothing: file "
                           f"{h['file']}, {h['keys']} keys")
    print(f"[50] {smi}: eval over the HDF5 file against the synthetic "
          f"store: {h['ms']:.2f} against {s['ms']:.2f} ms wall per step, "
          f"get_obs {h['get_obs']:.3f} against {s['get_obs']:.3f} ms, "
          f"pano_assemble {h['pano_assemble']:.3f} against "
          f"{s['pano_assemble']:.3f} ms per call; trajectories and "
          f"{len(h['logits'])} steps' logits equal bit for bit")
    return h["launches"]


def phase_hdf5_extract(tmp):
    """Phase 50 (d): the EVA02-CLIP-L-14-336 tower (random f32 weights from
    load_eva02's seed 0) encodes HDF5_EVA_VIEWPOINTS x 36 synthetic views,
    written by the extractors' writer (vision.extract.write_features):
    the file reads back through ImageFeaturesDB equal to encode's output
    bit for bit. Then the entry point python -m
    navillm_tpu_torch.vision.extract_features_mp3d (PIL decoding in
    threads, FeatureExtractor.extract_to_hdf5's writer) over 36 PNG
    renders of each of HDF5_EVA_VIEWPOINTS viewpoints: its file's
    features within VIT_REL of FeatureExtractor.encode_images on the same
    renders. (--workers 2, spawned decoders and the writer thread, took
    11.5-12.8 s of the phase's 25-29 s; the CPU tests hold that writer.)"""
    from PIL import Image

    from navillm_tpu_torch.vision import extract_features_mp3d as EM
    from navillm_tpu_torch.vision.extract import DirectoryImageSource
    vcfg, params = EM.load_eva02(None, "cuda", 0)
    fe = FeatureExtractor(params, vcfg, batch_size=VIT_VIEWS)
    gen = torch.Generator(device="cuda").manual_seed(45)
    imgs = torch.randn((HDF5_EVA_VIEWPOINTS * VIT_VIEWS, vcfg.image_size,
                        vcfg.image_size, 3), generator=gen, device="cuda")
    path = f"{tmp}/eva02.hdf5"
    feats = {}
    t0 = time.perf_counter()
    with hdf5.File(path, "w") as f:
        for k in range(HDF5_EVA_VIEWPOINTS):
            feats[f"vp{k}"] = fe.encode(imgs[k * VIT_VIEWS:
                                             (k + 1) * VIT_VIEWS])
            write_features(f, f"evascan_vp{k}", feats[f"vp{k}"])
    dt = time.perf_counter() - t0
    db = ImageFeaturesDB(path, vcfg.width)
    bad = [vp for vp, want in feats.items()
           if want.shape != (VIT_VIEWS, vcfg.width)
           or not same_bits(db.get_image_feature("evascan", vp), want)]
    if bad:
        raise RuntimeError(f"[50] EVA02 features of {bad} do not read back")
    print(f"[50] EVA02-CLIP-L-14-336: {HDF5_EVA_VIEWPOINTS} viewpoints x "
          f"{VIT_VIEWS} views encoded and written in {dt:.3f} s "
          f"({fe.forward_calls} forwards); read back through "
          f"ImageFeaturesDB bit for bit")

    conn, renders = Path(f"{tmp}/eva_conn"), Path(f"{tmp}/renders")
    conn.mkdir()
    T.make_grid_connectivity(conn, "evascan", rows=1,
                             cols=HDF5_EVA_VIEWPOINTS)
    rng = np.random.RandomState(50)
    scanvps = [("evascan", f"vp_0_{c}") for c in range(HDF5_EVA_VIEWPOINTS)]
    for scan, vp in scanvps:
        (renders / scan).mkdir(parents=True, exist_ok=True)
        for ix in range(VIT_VIEWS):
            Image.fromarray(rng.randint(0, 256, (48, 64, 3), np.uint8)) \
                .save(renders / scan / f"{vp}_{ix}.png")
    out = f"{tmp}/mp3d_eva02.hdf5"
    t0 = time.perf_counter()
    EM.main(["--connectivity_dir", str(conn), "--image_dir", str(renders),
             "--output_file", out])
    dt = time.perf_counter() - t0
    db, src = ImageFeaturesDB(out, vcfg.width), DirectoryImageSource(renders)
    with hdf5.File(out) as f:
        keys = sorted(f.keys())
    rel = 0.0
    for scan, vp in scanvps:
        want = fe.encode_images(src.views(scan, vp, VIT_VIEWS))
        got = db.get_image_feature(scan, vp)
        rel = max(rel, float(np.abs(got - want).max() / np.abs(want).max()))
    if keys != [f"{s}_{v}" for s, v in scanvps] or not rel <= VIT_REL:
        raise RuntimeError(f"[50] extract_features_mp3d wrote {keys}; "
                           f"max |d|/max|f| {rel:.3e} > {VIT_REL}")
    print(f"[50] python -m navillm_tpu_torch.vision.extract_features_mp3d "
          f"over {len(scanvps)} viewpoints x {VIT_VIEWS} PNG "
          f"renders in {dt:.2f} s: {keys}, against encode_images max "
          f"|d|/max|f| {rel:.3e}")
    del params, fe, imgs
    torch.cuda.empty_cache()


def phase_hdf5(bpe, cfg, model, tmp, smi, cli_ref):
    """Phase 50: the HDF5 feature files without h5py, (a)-(d) above and
    phase_cli's (c). Gate: the run loaded no h5py module. Returns (the
    eval's K1 launches, the entry point's launches)."""
    t_phase = time.perf_counter()
    phase_hdf5_fixture()
    anno, path = phase_hdf5_io(tmp, cfg.pano.image_feat_size, smi)
    eval_launches = phase_hdf5_eval(bpe, cfg, model, anno, path, smi)
    cli_launches, _ = phase_cli(f"{tmp}/cli", ref=cli_ref)
    phase_hdf5_extract(tmp)
    if "h5py" in sys.modules:
        raise RuntimeError("[50] the run loaded h5py")
    print(f"[50] phase {time.perf_counter() - t_phase:.1f} s")
    return eval_launches, cli_launches


# ------------------------------------- slice 17: a LLaMA-3-layout directory --- #
LLAMA3_FIXTURE = Path(__file__).resolve().parent / "tests/fixtures/llama3_bpe"
# phase 49's R2R episodes: bf16 uncached and prefix-cached, then int4
LLAMA3_EPISODES = 16
LLAMA3_W4_EPISODES = 8
# Meta-Llama-3-8B's architecture as its config.json gives it: (hidden,
# layers, heads, KV heads, MLP, rope_theta, rms_norm_eps, positions)
LLAMA3_8B = (4096, 32, 32, 8, 14336, 500000.0, 1e-5, 8192)
# K4 at the 8B layer shapes that no 7B phase runs: wk/wv (o = 8 KV heads x
# 128), w_gate/w_up (o = 14336) and w_down (h = 14336)
Q4_LLAMA3_SHAPES = ((4096, 1024), (4096, 14336), (14336, 4096))


def llm_bytes(llm) -> dict:
    """Bytes of the LLM's embedding, lm_head and layer leaves."""
    out = {"embed": 0, "lm_head": 0, "layers": 0}
    for name, p in llm.named_parameters():
        key = name.split(".")[0]
        out[key if key in out else "layers"] += p.numel() * p.element_size()
    return out


def recording(runner, name, sink, pick):
    """runner.<name> wrapped to append pick(args) of every call to
    ``sink``."""
    fn = getattr(runner, name)

    def wrapped(*a, **kw):
        sink.append(pick(a))
        return fn(*a, **kw)
    setattr(runner, name, wrapped)


def phase_gqa_kernel(tag, b, t, padding: str):
    """K1 at 32 query heads over 8 KV heads (head dim 128, causal) on [B, T]
    key masks padded on the ``padding`` side (left: an eval step's; right:
    a prefill's): held to its plain version by phase 2's gate (planted
    faults on the rows that see LONG_ROW keys or more), then timed beside
    the plain version and masked SDPA with enable_gqa (the library
    yardstick). Returns the row of timings."""
    nh, nkv, d = 32, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(49)
    mask = left_padded_mask(b, t) if padding == "left" \
        else right_padded_mask(b, t)
    q, k, v = randn(gen, b, t, nh, d), randn(gen, b, t, nkv, d), \
        randn(gen, b, t, nkv, d)
    scale = d ** -0.5
    with torch.inference_mode():
        o, lse = flash_attention_fwd(q, k, v, mask, causal=True, scale=scale)
        ro, rlse = flash_attention_fwd_reference(q, k, v, mask, True, scale)
        torch.cuda.synchronize()
        if not (torch.isfinite(o).all() and torch.isfinite(lse).all()):
            raise RuntimeError(f"[{tag}] K1 at B={b} T={t} GQA 32/8: output "
                               f"is not finite")
        seen = T.visible_keys(mask, t, True)
        rows, long_rows = seen > 0, seen >= LONG_ROW
        err = (o.float() - ro.float()).abs()[rows].max().item()
        err_lse = (lse - rlse).abs().transpose(1, 2)[rows].max().item()
        faults = [(name, flash_attention_fwd_reference(
            q, k, v, hide_keys(mask, min(128, t // 2), w), True, scale)[0])
            for name, w in (("one key hidden", 1),
                            ("one 64-key tile hidden", 64))
            if long_rows.any()]
        excess = gate(f"[{tag}] K1 B={b} T={t} NH=32 NKV=8 D=128 causal, "
                      f"max|dO|={err:.3e} max|dlse|={err_lse:.3e}", o, ro,
                      rows, faults, long_rows)
        if err_lse > LSE_ATOL:
            raise RuntimeError(f"[{tag}] K1's lse disagrees with its plain "
                               f"version")
        del faults
        ms = cuda_ms(lambda: flash_attention_fwd(q, k, v, mask, causal=True,
                                                 scale=scale))
        plain_ms = cuda_ms(lambda: flash_attention_fwd_reference(
            q, k, v, mask, True, scale), iters=5)
        library = sdpa_call(q, k, v, mask, True, scale)
        library_ms = cuda_ms(library)
        lib_err = (library().transpose(1, 2).float()
                   - ro.float()).abs()[rows].max().item()
    bound_ms, by = fwd_bound(b, t, t, nh, nkv, d, True)
    print(f"[{tag}] K1 B={b} T={t} GQA 32/8: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, masked SDPA (enable_gqa) {library_ms:.4f} ms "
          f"(max|d| {lib_err:.3e} from the plain version), bound "
          f"{bound_ms:.4f} ms ({by})")
    return {"max_abs_err": err, "gate_excess": excess, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "library_max_abs_err": lib_err, "bound_ms": bound_ms,
            "bound_by": by}


def phase_llama3(tmp, smi):
    """Phase 49: a Meta-Llama-3-8B-shaped directory through the CLI's
    entry points (read_args -> build_runner with
    --pretrained_model_name_or_path DIR --from_scratch --precision bf16):
    Meta-Llama-3-8B's config.json (GQA 32/8, MLP 14336, vocabulary 128256,
    rope_theta 500000) and a LLaMA-3-layout tokenizer.json of 128000 BPE
    entries and 256 special tokens (testing.write_llama3_checkpoint from
    the committed fixture), random bf16 weights from the seed. Runs
    LLAMA3_EPISODES R2R episodes of streaming evaluation uncached, then
    prefix-cached (phase 14's gates: no uncached step, K1 32 per prefill),
    phase 15's cached-vs-uncached A/B (C-w1), and LLAMA3_W4_EPISODES on the
    tree quantized to int4 on the card (K4 224 per LLM pass); phase_slice's
    gates on each (trajectories start at the ground truth, metrics finite,
    K1 32 per uncached step). Every prompt of the first run encodes to the
    ids a fresh load of the file gives. K1 is held to its plain version at
    32/8 heads at the step's and the prefill's shapes, K4 at
    Q4_LLAMA3_SHAPES for the int4 step's m and m = 4, each timed beside
    its bound and library call. Returns ({K1 launches by phase}, {K4
    launches by phase}, {K1 shape: timings}, {K4 (m, h, o, mode):
    timings})."""
    from navillm_tpu_torch.models.tokenization import TokenizerFile
    t_phase = time.perf_counter()
    base = json.loads((LLAMA3_FIXTURE / "tokenizer.json").read_text(
        encoding="utf-8"))
    d = Path(tmp) / "llama3_8b"
    t0 = time.perf_counter()
    T.write_llama3_checkpoint(d, base)
    make_s = time.perf_counter() - t0
    args, ycfg = read_args([
        "--cfg_file", pretrained_yaml(tmp, 1024), "--output_dir",
        f"{tmp}/llama3_out", "--pretrained_model_name_or_path", str(d),
        "--from_scratch", "--precision", "bf16"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner = TTL.build_runner(args, ycfg)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    llm, tok = runner.cfg.llm, runner.tok
    arch = (llm.hidden_size, llm.num_layers, llm.num_heads, llm.num_kv_heads,
            llm.intermediate_size, llm.rope_theta, llm.rms_norm_eps,
            llm.max_seq_len)
    device = runner.device
    if arch != LLAMA3_8B or llm.vocab_size != tok.vocab_size \
            or (tok.bos_id, tok.eos_id, tok.true_vocab_size) != (
                T.LLAMA3_VOCAB, T.LLAMA3_VOCAB + 1, T.LLAMA3_VOCAB + 262) \
            or tok.pad_id != tok.unk_id:
        raise RuntimeError(f"[49] build_runner built {arch} with vocabulary "
                           f"{llm.vocab_size}; tokenizer "
                           f"bos {tok.bos_id} eos {tok.eos_id} pad "
                           f"{tok.pad_id} unk {tok.unk_id}, "
                           f"{tok.true_vocab_size} ids")
    nbytes = llm_bytes(runner.model.llm)
    print(f"[49] Meta-Llama-3-8B-shaped directory (config.json: hidden "
          f"{llm.hidden_size}, {llm.num_layers} layers, {llm.num_heads} "
          f"heads over {llm.num_kv_heads} KV heads, MLP "
          f"{llm.intermediate_size}, rope_theta {llm.rope_theta}; "
          f"tokenizer.json of {T.LLAMA3_VOCAB} BPE entries and 256 special "
          f"tokens, made and written in {make_s:.2f} s) through read_args "
          f"-> build_runner --from_scratch in {build_s:.2f} s: vocabulary "
          f"{tok.true_vocab_size} ids (<PAD> {tok.pad_id} added, unk = pad) "
          f"padded to {llm.vocab_size}; bf16 LLM {sum(nbytes.values()) / 1e9:.3f}"
          f" GB (embed {nbytes['embed'] / 1e9:.3f}, lm_head "
          f"{nbytes['lm_head'] / 1e9:.3f}, layers "
          f"{nbytes['layers'] / 1e9:.3f}); {smi}")
    runner.dims = slice_dims()
    steps, prefills = [], []
    recording(runner, "eval_step", steps, lambda a: a[2]["input_ids"].shape)
    recording(runner, "prefill", prefills, lambda a: a[1].shape)
    prompts = []
    trajs, stats = phase_slice(49, tok, runner.cfg, runner.model,
                               f"{tmp}/l3_eval", prompts=prompts,
                               runner=runner, n_episodes=LLAMA3_EPISODES)
    step_shape = max(steps[-stats["eval_steps"]:], key=lambda s: s[1])
    cached_trajs, cached_stats = phase_slice(
        49, tok, runner.cfg, runner.model, f"{tmp}/l3_cached",
        prefix_cache=True, runner=runner, n_episodes=LLAMA3_EPISODES)
    report_cached(49, runner.cfg, cached_trajs, cached_stats, trajs, stats,
                  49)
    pre_shape = max(prefills, key=lambda s: s[1])
    phase_cached_ab(tok, runner.cfg, runner.model, f"{tmp}/l3_ab", tag=49)
    # the prompts against a second, fresh load of the directory's files
    texts = list(dict.fromkeys(prompts))
    t0 = time.perf_counter()
    TokenizerFile(d / "tokenizer.json")
    file_s = time.perf_counter() - t0
    tok2, nav_s = timed_tokenizer(str(d))
    ms = encode_ms(tok2, texts)
    ids = [tok2.encode(t, add_bos=False) for t in texts]
    bad = [t for t, i in zip(texts, ids)
           if tok.encode(t, add_bos=False) != i]
    if bad or not texts:
        raise RuntimeError(f"[49] {len(bad)} of {len(texts)} prompts encode "
                           f"to other ids than a fresh load of the file")
    lengths = [len(i) for i in ids]
    print(f"[49] {len(prompts)} prompts of the uncached run ({len(texts)} "
          f"distinct, {min(lengths)}-{max(lengths)} tokens) encode to the "
          f"ids of a fresh load of the {T.LLAMA3_VOCAB}-entry file; load "
          f"{file_s * 1e3:.1f} ms (TokenizerFile) and {nav_s * 1e3:.1f} ms "
          f"(NavTokenizer.from_pretrained, the schema tokens added); encode "
          f"{ms:.3f} ms per prompt; {smi}")
    # K1 at 32/8 heads: the widest uncached step and prefill
    k1 = {f"{kind} B={b} T={t}": phase_gqa_kernel(49, b, t, padding)
          for kind, (b, t), padding in (("step", step_shape, "left"),
                                        ("prefill", pre_shape, "right"))}
    # the int4 tree
    cfg = runner.cfg
    with torch.no_grad():
        qmodel = NavModel(cfg, quantize_nav_params(runner.model, bits=4))
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    qbytes = llm_bytes(qmodel.llm)
    w4_trajs, w4_stats = phase_slice(49, tok, cfg, qmodel, f"{tmp}/l3_w4",
                                     n_episodes=LLAMA3_W4_EPISODES)
    passes = w4_stats["steps"] + w4_stats["prefill_calls"]
    want = passes * cfg.llm.num_layers * Q4_LAYER_MATMULS
    if w4_stats["q4_launches"] != want:
        raise RuntimeError(f"[49] K4 launches {w4_stats['q4_launches']} != "
                           f"{passes} LLM passes x {cfg.llm.num_layers} x "
                           f"{Q4_LAYER_MATMULS}")
    m = N_SLOTS * step_shape[1]
    q4 = phase_q4_kernel(tag=49, rows=(m, 4), modes=("w4",),
                         shapes=Q4_LLAMA3_SHAPES)
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[49] int4 LLM {sum(qbytes.values()) / 1e9:.3f} GB (layers "
          f"{qbytes['layers'] / 1e9:.3f} GB with their scales) against bf16 "
          f"{sum(nbytes.values()) / 1e9:.3f}; K4 {w4_stats['q4_launches']} = "
          f"{passes} LLM passes x {cfg.llm.num_layers} x {Q4_LAYER_MATMULS};"
          f" ms per step bf16 uncached {stats['ms_per_step']:.2f}, cached "
          f"{cached_stats['ms_per_step']:.2f}, int4 "
          f"{w4_stats['ms_per_step']:.2f}; LLM tokens per step "
          f"{stats['token_units'] / stats['steps']:.1f}, "
          f"{cached_stats['token_units'] / cached_stats['steps']:.1f}, "
          f"{w4_stats['token_units'] / w4_stats['steps']:.1f}; peak "
          f"{stats['peak_gib']:.2f}, {cached_stats['peak_gib']:.2f}, "
          f"{w4_stats['peak_gib']:.2f} GiB; phase 49 in "
          f"{time.perf_counter() - t_phase:.1f} s; {smi}")
    if device.type != "cuda":
        raise RuntimeError(f"[49] build_runner ran on {device}")
    return ({"49": stats["launches"], "49_cached": cached_stats["launches"],
             "49_w4": w4_stats["launches"]},
            {"49_w4": w4_stats["q4_launches"]}, k1, q4)


def time_phases():
    """Wrap every top-level phase function so that each call prints its wall
    seconds (nested calls print their own line): the budget of the whole
    run is read from these lines."""
    g = globals()
    for name in [n for n in g if n.startswith("phase_")
                 or n in ("model_7b", "quantize_model")]:
        def timed(*a, _fn=g[name], _name=name, **kw):
            t = time.perf_counter()
            try:
                return _fn(*a, **kw)
            finally:
                print(f"[time] {_name} {time.perf_counter() - t:.1f} s",
                      flush=True)
        g[name] = functools.wraps(g[name])(timed)


def main():
    t_main = time.perf_counter()
    time_phases()
    smi = phase_device()
    phase_build()
    fwd_err, fwd_timed = phase_kernel()
    window_row = phase_window_kernel()
    tok, cfg, model = model_7b()
    prompts = []
    with tempfile.TemporaryDirectory() as tmp:
        dense_trajs, _ = phase_slice(3, tok, cfg, model, tmp, prompts=prompts)
    phase_ab(cfg, model)
    # the BPE slices at 7B width, bf16, before training moves the weights
    bpe = NavTokenizer.bpe(max_length=1024, pad_to_multiple=64)
    phase_bpe_check(tok, bpe, prompts)
    with tempfile.TemporaryDirectory() as tmp:
        bpe_trajs, bpe_stats = phase_slice(13, bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        cached_trajs, cached_stats = phase_slice(14, bpe, cfg, model, tmp,
                                                 prefix_cache=True)
    report_cached(14, cfg, cached_trajs, cached_stats, bpe_trajs, bpe_stats,
                  13)
    with tempfile.TemporaryDirectory() as tmp:
        phase_cached_ab(bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        phase_sampled_ab(bpe, cfg, model, tmp)
    bwd_err, bwd_timed = phase_backward()
    with tempfile.TemporaryDirectory() as tmp:
        launches, call = phase_train(tok, cfg, model, tmp)
    phase_grad_ab(tok, cfg, model, call)
    del call
    # the DAgger half and the training driver, at 7B width on BPE prompts,
    # before the int4 phases free the bf16 LLM
    with tempfile.TemporaryDirectory() as tmp:
        dagger_launches, dagger = phase_dagger(bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        phase_sampler(bpe, cfg, model, tmp)
    # the W8A8 sampling policy (--dagger_sample_quant), phase 18's cell
    with tempfile.TemporaryDirectory() as tmp:
        dagger_q_launches, dagger_q = phase_dagger(bpe, cfg, model, tmp,
                                                   tag=43, sample_quant=True)
    print(f"[43] W8A8 sampling {[round(x, 1) for x in dagger_q['sample_ms']]}"
          f" ms per DAgger batch against phase 18's bf16 sampling "
          f"{[round(x, 1) for x in dagger['sample_ms']]} ms; "
          f"{dagger_q['quantizations']} quantizations for "
          f"{dagger_q['opt_steps']} optimizer steps, "
          f"{dagger_q['quant_ms'] / max(dagger_q['quantizations'], 1):.1f} "
          f"ms each; peak {dagger_q['peak_gib']:.2f} GiB against "
          f"{dagger['peak_gib']:.2f}")
    with tempfile.TemporaryDirectory() as tmp:
        phase_sample_quant_ab(bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        run_launches = phase_run_training(bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches, cli_ref = phase_cli(tmp)
    # generation at 7B width: the EQA path and training with the heads
    with tempfile.TemporaryDirectory() as tmp:
        phase_gen_ab(bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        eqa = phase_eqa(23, bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        eqa_cached = phase_eqa(23, bpe, cfg, model, tmp, prefix_cache=True,
                               warm_up=False)
    print(f"[23] cached against uncached: {eqa_cached['ms_per_step']:.2f} "
          f"against {eqa['ms_per_step']:.2f} ms per nav step, "
          f"{eqa_cached['ms_per_generate']:.1f} against "
          f"{eqa['ms_per_generate']:.1f} ms per generate call, "
          f"{eqa_cached['episodes_per_s']:.3f} against "
          f"{eqa['episodes_per_s']:.3f} episodes/s")
    with tempfile.TemporaryDirectory() as tmp:
        gen_launches = phase_run_gen(bpe, cfg, model, tmp)
    # object grounding at 7B width: REVERIE and SOON evaluation and training
    # with the OG head
    with tempfile.TemporaryDirectory() as tmp:
        phase_og_ab(bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        og_evals = phase_og_evals(bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        og_launches = phase_run_og(bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        og_cli_launches = phase_cli_og(tmp)
    # the rest of the paper's task mix at 7B width: CVDN and ScanQA
    # evaluation, training over configs/multi.yaml's six sources, and the
    # CLI at stage pretrain and stage multi
    with tempfile.TemporaryDirectory() as tmp:
        cvdn = phase_cvdn_evals(bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        scanqa = phase_scanqa(bpe, cfg, model, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        mix_launches, mix_peak = phase_run_mix(bpe, cfg, model, tmp)
    cli_mix = {}
    t32 = time.perf_counter()
    for stage in ("pretrain", "multi"):
        with tempfile.TemporaryDirectory() as tmp:
            cli_mix[stage] = phase_cli_mix(tmp, stage)
    with tempfile.TemporaryDirectory() as tmp:
        cli_mix["pretrain_jsonl"], _ = phase_cli_jsonl(tmp)
    print(f"[32] phase 32 in {time.perf_counter() - t32:.1f} s")
    # the per-step paths at 7B width: the per-step rollouts, the
    # interleaved DAgger streams, batched validation, the host-memory runner
    # and training on EQA batches
    perstep = {}
    for tag, fn in (("36", phase_perstep_train), ("37", phase_pipeline),
                    ("38", phase_batched_eval), ("39", phase_hostmem),
                    ("40", phase_eqa_train)):
        with tempfile.TemporaryDirectory() as tmp:
            perstep[tag] = fn(bpe, cfg, model, tmp)
    # the feature prefetcher on the fused trainers over a disk-backed store
    with tempfile.TemporaryDirectory() as tmp:
        prefetch_launches, prefetch_eval = phase_prefetch(bpe, cfg, model,
                                                          tmp, smi)
    # the HDF5 feature files read and written without h5py: phase 13's
    # eval over one, the entry point over its feature_database
    with tempfile.TemporaryDirectory() as tmp:
        hdf5_eval, hdf5_cli = phase_hdf5(bpe, cfg, model, tmp, smi,
                                         {**cli_ref, "launches": cli_launches})
    # the pretrained path: the model's LLM written as an HF-layout
    # checkpoint and read back through build_runner; the directory serves
    # phases 34 and 35 too
    pre_dir = tempfile.TemporaryDirectory()
    vic = f"{pre_dir.name}/vicuna"
    t33 = time.perf_counter()
    load_launches = phase_load(cfg, model, vic, pre_dir.name)
    spm_launches, _ = phase_spm(cfg, vic, pre_dir.name)
    print(f"[33] phase 33 in {time.perf_counter() - t33:.1f} s")
    q4 = phase_q4_kernel()
    qmodel = quantize_model(cfg, model)
    # free the bf16 LLM: the phases' runners hold it in reference cycles
    # (their wrapped methods), so it goes with a collection
    del model
    gc.collect()
    torch.cuda.empty_cache()
    a8 = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm,
                                                          act_int8=True))
    with tempfile.TemporaryDirectory() as tmp:
        launches["q4"], w4, w4_stats = phase_q4_slice(
            9, tok, cfg, qmodel, tmp, dense_trajs, warm_up=True)
    with tempfile.TemporaryDirectory() as tmp:
        _, w4a8, w4a8_stats = phase_q4_slice(10, tok, a8, qmodel, tmp,
                                             dense_trajs, warm_up=False)
    print(f"[10] w4a8 trajectories equal to w4's (same int4 tree): "
          f"{sum(w4a8[k] == w4[k] for k in w4)} of {len(w4)}")
    # the cached BPE slices on the int4 tree: prefills and cached steps
    # through K4
    for tag, c, warm, ref, ref_tag in ((16, cfg, True, w4_stats, 9),
                                       (17, a8, False, w4a8_stats, 10)):
        with tempfile.TemporaryDirectory() as tmp:
            _, _, st = phase_q4_slice(tag, bpe, c, qmodel, tmp, bpe_trajs,
                                      warm_up=warm, prefix_cache=True,
                                      dense_tag=13)
        print(f"[{tag}] {st['ms_per_step']:.2f} ms wall per cached BPE step "
              f"and peak memory {st['peak_gib']:.2f} GiB, beside phase "
              f"{ref_tag}'s byte-prompt uncached {ref['ms_per_step']:.2f} ms "
              f"and {ref['peak_gib']:.2f} GiB")
    for c in (cfg, a8):
        plain = dataclasses.replace(c, llm=dataclasses.replace(
            c.llm, q4_impl="plain"))
        mode = "w4a8" if c.llm.act_int8 else "w4"
        compare_logits(11, f"on the int4 tree ({mode}): kernel vs plain "
                       f"version", qmodel, c, plain)
    with tempfile.TemporaryDirectory() as tmp:
        eqa_w4, q4_decode = phase_eqa_w4(bpe, cfg, qmodel, tmp, eqa)
    # the rest of quantization on the int4 tree: w4a8 generation with an
    # int8 prompt K/V, then REVERIE, SOON and CVDN
    with tempfile.TemporaryDirectory() as tmp:
        eqa_a8 = phase_eqa_w4a8(bpe, cfg, qmodel, tmp, eqa_w4)
    with tempfile.TemporaryDirectory() as tmp:
        int4_mix = phase_int4_og_cvdn(bpe, cfg, qmodel, tmp)
    # int8 weights (drawn quantized), W8A8 and the int8 prefix cache, at
    # Vicuna-7B's own depth (CACHED_LOGIT_SPREAD_A8KV8)
    cfg41 = dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, num_layers=LlamaConfig.vicuna_7b().num_layers))
    model8 = phase_quantized_init(cfg41)
    with tempfile.TemporaryDirectory() as tmp:
        w8a8 = phase_w8a8(bpe, cfg41, model8, tmp)
    del model8
    gc.collect()
    torch.cuda.empty_cache()
    # the pretrained path's training (8-bit moments) and resume, then its
    # int4 evaluation, after the bf16 model is gone
    with tempfile.TemporaryDirectory() as tmp:
        pre_launches, pre_peak = phase_pretrained_train(vic, tmp)
    print(f"[34] training peak {pre_peak:.2f} GiB with 8-bit moments, "
          f"against phase 31's {mix_peak:.2f} GiB with AdamW (6 tasks and "
          f"the heads)")
    with tempfile.TemporaryDirectory() as tmp:
        int4_launches, int4_q4 = phase_pretrained_int4(vic, tmp, tok, cfg,
                                                       qmodel, w4)
    pre_dir.cleanup()
    # slice 14: the feature-extraction towers, then tp=2 evaluation and
    # dp=2 x tp=2 training in spawned ranks that share the card
    del qmodel
    gc.collect()
    torch.cuda.empty_cache()
    phase_vision()
    with tempfile.TemporaryDirectory() as tmp:
        tp_eval, _ = phase_tp_eval(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        dp_tp = phase_dp_tp_train(tmp)
    tp0 = tp_eval[0]
    # slice 17: a Meta-Llama-3-8B-shaped directory (GQA 32/8) on one card
    with tempfile.TemporaryDirectory() as tmp:
        l3_launches, l3_q4, l3_k1, l3_k4 = phase_llama3(tmp, smi)
    # K1 at the eval slice's widest prompts (B=4, T=1024), K2/K3 at the
    # training slice's (B=16, T=1024), K4 at the w_gate shape with 4 slots
    # of 1024 tokens (w4); launches from the measured runs of phases 6
    # (K1-K3) and 9 (K4), and per phase of the training paths (6, 18, 20,
    # 21)
    sdpa = ("F.scaled_dot_product_attention on the [B, NH, T, D] views with "
            "the same boolean mask (causal AND key mask)")
    def by_phase(key):
        return {"6": launches[key], "18": dagger_launches[key],
                "20": run_launches[key], "21": cli_launches[key],
                "23": eqa["launches"][key],
                "23_cached": eqa_cached["launches"][key],
                "24": gen_launches[key],
                **{f"27_{t.lower()}{sfx}": og_evals[t][j]["launches"][key]
                   for t in og_evals
                   for j, sfx in enumerate(("", "_cached"))},
                "28": og_launches[key], "28_cli": og_cli_launches[key],
                "29": cvdn[0]["launches"][key],
                "29_cached": cvdn[1]["launches"][key],
                "30": scanqa["launches"][key], "31": mix_launches[key],
                **{f"32_{st}": cli_mix[st][key] for st in cli_mix},
                "36": perstep["36"][key], "37": perstep["37"][key],
                **{f"38_{t.lower()}": n[key]
                   for t, n in perstep["38"].items()},
                "39": perstep["39"][key], "40": perstep["40"][key],
                "48": prefetch_launches[key],
                "48_eval": prefetch_eval if key == "fwd" else 0,
                "50": hdf5_eval if key == "fwd" else 0,
                "50_cli": hdf5_cli[key],
                "41": w8a8["launches"] if key == "fwd" else 0,
                **{f"42{sfx}": st["launches"][key]
                   for sfx, st in zip(("", "_kv8"), eqa_a8)},
                "43": dagger_q_launches[key],
                **{f"44_{k}": v["launches"][key]
                   for k, v in int4_mix.items()},
                "33": load_launches[key], "33_spm": spm_launches[key],
                **{ph: n[key] for ph, n in pre_launches.items()},
                **{ph: n[key] for ph, n in int4_launches.items()},
                # rank 0 of each spawned run (its 16 heads; rank 1 the same)
                **{f"46_{kind}{'_cached' if c else ''}":
                   tp0[kind]["stats"][c]["launches"] if key == "fwd" else 0
                   for kind in ("bf16", "w4") for c in (False, True)},
                "47": dp_tp[0]["launches"][key],
                **{ph: n if key == "fwd" else 0
                   for ph, n in l3_launches.items()}}
    rows = [{**KERNELS["fwd"], "launches": launches["fwd"],
             "launches_by_phase": by_phase("fwd"),
             **fwd_err, **fwd_timed[(4, 1024)],
             "max_abs_err": max(fwd_err["max_abs_err"], *(
                 r["max_abs_err"] for r in l3_k1.values())),
             "shape": "B=4 T=S=1024 NH=32 D=128 causal", "library": sdpa,
             "gqa_32_8": {shape: {k: r[k] for k in (
                 "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                 "bound_by")} for shape, r in l3_k1.items()}}]
    rows.append({**KERNELS["window"], **window_row,
                 "launches": cached_stats["window_launches"],
                 "launches_by_phase": {"14": cached_stats["window_launches"]},
                 "shape": f"B=16 S=99 P={MAX_PREFIX} NH=32 NKV=8 D=128",
                 "library": "masked F.scaled_dot_product_attention over the "
                            "concatenated K/V, [B, S, P+S] mask"})
    for key in ("dkv", "dq"):
        rows.append({**KERNELS[key], "launches": launches[key],
                     "launches_by_phase": by_phase(key),
                     **bwd_err[key], **bwd_timed[1024][key],
                     "shape": "B=16 T=S=1024 NH=32 D=128 causal",
                     "library": "the backward of " + sdpa + " (dQ, dK, dV "
                                "and delta in one call)"})
    rows.append({**KERNELS["q4"], "launches": launches["q4"],
                 "launches_by_phase": {"9": launches["q4"],
                                       "25": eqa_w4["q4_launches"],
                                       **int4_q4,
                                       **{f"42{sfx}": st["q4_launches"]
                                          for sfx, st in zip(("", "_kv8"),
                                                             eqa_a8)},
                                       **{f"44_{k}": v["q4_launches"]
                                          for k, v in int4_mix.items()},
                                       **{f"46_w4{'_cached' if c else ''}":
                                          n for c, n in tp0["w4"]["q4"]
                                          .items()},
                                       **l3_q4},
                 **q4[(4096, 4096, 11008, "w4")],
                 "max_abs_err": max(r["max_abs_err"] for r in
                                    [*q4.values(), *q4_decode.values(),
                                     *l3_k4.values()]),
                 "shape": "m=4096 h=4096 o=11008 w4",
                 "decode_m4": {f"h={h} o={o}": {k: r[k] for k in (
                     "max_abs_err", "ms", "plain_ms", "library_ms",
                     "bound_ms", "bound_by")}
                     for (m, h, o, _), r in q4_decode.items()},
                 "f32_x": {f"m={m} h={h} o={o}": {k: r[k] for k in (
                     "max_abs_err", "ms", "bf16_x_ms", "plain_ms",
                     "library_ms", "bound_ms", "bound_by")}
                     for (m, h, o, mode), r in q4.items()
                     if mode == "f32" and m == 4096},
                 "tp2_shards": {f"m={m} h={h} o={o}": {k: r[k] for k in (
                     "max_abs_err", "ms", "plain_ms", "library_ms",
                     "bound_ms", "bound_by")}
                     for (m, h, o, _), r in tp0["q4_check"].items()},
                 "llama3_8b": {f"m={m} h={h} o={o}": {k: r[k] for k in (
                     "max_abs_err", "ms", "plain_ms", "library_ms",
                     "bound_ms", "bound_by")}
                     for (m, h, o, _), r in l3_k4.items()}})
    print(f"[run] phases 0-50 in {time.perf_counter() - t_main:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
