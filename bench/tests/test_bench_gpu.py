"""On the card: the reference's int8 matmuls give the exact product sums
at the shapes its projections use."""
import pytest
import torch

from bench.reference.decoder import Products
from bench.reference.multiplier import product_table


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N", [(3, 4096, 8), (40, 16384, 64),
                                   (300, 4096, 1024)])
def test_card_product_sums_are_exact(M, K, N):
    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(M)
    qa = torch.randint(0, 256, (M, K), generator=g, device=dev)
    qw = torch.randint(0, 256, (K, N), generator=g,
                       device=dev).to(torch.uint8)
    tab = torch.as_tensor(product_table(), device=dev)
    direct = torch.zeros((M, N), dtype=torch.float64, device=dev)
    for k0 in range(0, K, 512):
        direct += tab[qa[:, k0:k0 + 512, None],
                      qw[k0:k0 + 512].long()[None]].sum(1).double()
    assert torch.equal(Products(dev).sums(qa, qw), direct)
