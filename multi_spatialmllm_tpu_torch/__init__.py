"""multi_spatialmllm_tpu_torch — the PyTorch/CUDA port of
multi_spatialmllm_tpu for one NVIDIA H100 (sm_90a).

The JAX package stays the reference; this package imports torch and never
jax, and nothing of the JAX package: host code it needs from there (the
tokenizer and its vocabulary, image preprocessing, batch assembly, the
mixture stream, named rng streams, the scene store and synthetic scenes,
the manifest, the QA templates and samplers, the native JSONL emitter) is
copied into it, and tests/test_torch_copies.py holds each copy to its
original.

  core/      geometry (torch), scene store, synthetic scenes, rng streams
  stages/    the visibility index and the pairwise frame relations on the
             device, the stage manifest
  engines/   the camera-movement QA engine and its columnar JSONL emitter
  ingest/    the native emitter (C++, built with g++ at first use)
  pipeline   the data engine's ported path under the manifest
  models/    ViT + projector + decoder LLM (training forward and losses),
             tokenizer, preprocessing, batches and mixtures, paged
             continuous batching
  ops/       attention ops, each backed by hand-written CUDA kernels
             (ops/csrc/) on CUDA tensors and by its plain PyTorch version on
             CPU tensors; the trainable flash-attention autograd op
  parallel/  the training step (optax-equivalent AdamW, accumulation) and
             rolling checkpoints
"""

__version__ = "0.1.0"
