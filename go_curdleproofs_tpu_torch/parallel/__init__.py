"""Batched and multi-device verification over torch.distributed (the JAX
package's go_curdleproofs_tpu/parallel/).

  msm.py     the sharded MSM: each rank its contiguous shard's window sums,
             one all_gather, a tree of point additions, the Horner tail;
             the process group helpers (make_group, init_file_group)
  batch.py   many Whisk shuffle proofs with one decode and one final MSM,
             that MSM optionally sharded over a group
  ranks.py   runs a function on k spawned ranks of one host (the CPU tests)
  dryrun.py  the sharded MSM and batched verification at protocol scale

The collectives run on a process group that the caller owns: gloo over CPU
tensors, NCCL over CUDA tensors (one rank a card). Nothing here picks the
backend.
"""
