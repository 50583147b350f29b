"""The bf16 flash attention's key tile against JAX's Pallas kernel's
blocks. In its own file: ``tests/test_torch_bf16.py`` holds 8 tests, the
most a port test file takes (ROADMAP, Tier-1 verify)."""
from jax.experimental.pallas.ops.tpu.flash_attention import BlockSizes

from guassianhand_tpu_torch.ops import flash_attention_cuda
from tests.torch_parity import one_torch_thread  # noqa: F401


def test_kernel_tile_is_jax_block_k():
    """The bf16 forward's key tile (``KERNEL_TILE``, the kernel's and its
    twin's) is the block_k that JAX's Pallas flash attention takes by
    default, the blocks whose running maximum P is rounded against."""
    block_k = BlockSizes.get_default(1, 4, 512, 512, 32).block_k
    assert flash_attention_cuda.KERNEL_TILE == block_k
