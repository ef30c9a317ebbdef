"""``device_copy`` (ops/rdma.py) copies bytes: any dtype, any byte count.

The MoE pipeline's ``.bf16-rdma`` chains post it on bfloat16 staging
buffers; the halo faces are float32.  On the CPU the wrapper runs
``copy_``; the ``test_cuda_*`` tests run the kernel on the card (marker
``needs_cuda``), bit for bit against ``copy_``."""

import pytest
import torch

from tenzing_tpu_torch.ops import rdma

# (dtype, shape): bf16 staging rows, odd byte counts (13 and 14 bytes, a
# 16-byte body plus a tail), and an f32 face
CASES = [(torch.bfloat16, (7, 128)), (torch.uint8, (13,)),
         (torch.bfloat16, (7,)), (torch.float32, (5, 3)),
         (torch.int32, (33,))]


def _src(dtype, shape, device="cpu"):
    n = 1
    for s in shape:
        n *= s
    return (torch.arange(n, device=device) % 251 - 100).to(dtype).view(shape)


@pytest.mark.parametrize("dtype,shape", CASES,
                         ids=[f"{str(d).split('.')[1]}-{s}" for d, s in CASES])
def test_copy_any_dtype_on_cpu(dtype, shape):
    src = _src(dtype, shape)
    dst = torch.zeros_like(src)
    before = dict(rdma.LAUNCHES)
    rdma.device_copy(src, dst)
    assert torch.equal(dst, src)
    assert rdma.LAUNCHES == before  # the plain version counts nothing


def test_copy_rejects_mismatched_buffers():
    with pytest.raises(TypeError, match="dtypes differ"):
        rdma.device_copy(torch.zeros(4, dtype=torch.bfloat16), torch.zeros(4))
    with pytest.raises(ValueError, match="shape"):
        rdma.device_copy(torch.zeros(4), torch.zeros(5))
    with pytest.raises(ValueError, match="contiguous"):
        rdma.device_copy(torch.zeros(4, 4).t(), torch.zeros(4, 4))


@pytest.mark.needs_cuda
def test_cuda_copy_any_dtype():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    for dtype, shape in CASES + [(torch.bfloat16, (9728, 128))]:
        src = _src(dtype, shape, "cuda")
        dst = torch.zeros_like(src)
        before = rdma.LAUNCHES["device_copy"]
        rdma.device_copy(src, dst)
        torch.cuda.synchronize()
        assert rdma.LAUNCHES["device_copy"] == before + 1
        assert torch.equal(dst, src), (dtype, shape)


# bytes one block of csrc/device_copy.cu moves in one unrolled step
# (kThreads x kUnroll x 16)
BLOCK_STEP = 256 * 8 * 16
# byte counts around the 16-byte body and its tail, around one block's
# unrolled step, a grid whose last step is partly unrolled, and a flagship x
# face (3 x 3 x 512 x 512 floats)
SIZES = [1, 15, 16, 17, BLOCK_STEP - 1, BLOCK_STEP, BLOCK_STEP + 1,
         5 * BLOCK_STEP + 48, 3 * 3 * 512 * 512 * 4]


@pytest.mark.needs_cuda
@pytest.mark.parametrize("nbytes", SIZES)
def test_cuda_copy_byte_counts(nbytes):
    """Every byte count equals copy_, counts one launch, and writes no byte
    past the copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    src = _src(torch.uint8, (nbytes,), "cuda")
    dst = torch.full((nbytes + 64,), 7, dtype=torch.uint8, device="cuda")
    before = rdma.LAUNCHES["device_copy"]
    rdma.device_copy(src, dst[:nbytes])
    torch.cuda.synchronize()
    assert rdma.LAUNCHES["device_copy"] == before + 1
    assert torch.equal(dst[:nbytes], src), nbytes
    assert bool((dst[nbytes:] == 7).all()), nbytes


@pytest.mark.needs_cuda
def test_cuda_copy_bf16_staging():
    """A bf16 MoE staging buffer (8 experts x 304 slots x 512): bit for
    bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    src = torch.randn(8 * 304, 512, device="cuda", generator=gen).bfloat16()
    dst = torch.zeros_like(src)
    rdma.device_copy(src, dst)
    torch.cuda.synchronize()
    assert torch.equal(dst, src)
