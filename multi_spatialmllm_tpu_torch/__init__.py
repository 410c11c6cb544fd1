"""multi_spatialmllm_tpu_torch — the PyTorch/CUDA port of
multi_spatialmllm_tpu for one NVIDIA H100 (sm_90a).

The JAX package stays the reference; this package imports torch and never
jax, and nothing of the JAX package: host code it needs from there (the
tokenizer and its vocabulary, image preprocessing, batch assembly, the
mixture stream, named rng streams) is copied into it.

  core/      named rng streams
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
