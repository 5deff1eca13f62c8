"""paper-alexnet: the paper's own benchmark family, expressed as the
GEMM-lowered AlexNet (im2col conv -> GEMM, as Caffe+BLAS executes it).

ReLU activations (the paper's sparsity source) + SparCE enabled: the
configuration of the paper's figures (``launch/figures.py``). Layer GEMM
shapes follow the standard AlexNet im2col lowering at batch 1
(M = output pixels, K = Cin*k*k, N = Cout), e.g. conv4: 169x3456x384 --
the paper's Fig. 17 matrix. Copied verbatim from the reference's
``repro/configs/paper_alexnet.py``."""
from repro_torch.configs.base import ArchConfig
from repro_torch.core.sasa import LayerSpec
from repro_torch.core.sparse_ops import SparsityConfig

CONFIG = ArchConfig(
    name="paper-alexnet",
    family="dense",
    num_layers=8,
    d_model=1024,
    num_heads=8,
    num_kv_heads=8,
    d_ff=3456,
    vocab_size=1000,
    mlp_act="relu",
    dtype="float32",
    sparsity=SparsityConfig(enabled=True, mode="reference"),
)

# AlexNet layer GEMMs (im2col, batch=1). act_sparsity: measured average
# input-feature sparsity per layer from the paper's Fig. 2 band (conv1
# input is the dense image).
ALEXNET_GEMMS = (
    LayerSpec("conv1", m=3025, k=363, n=96, act_sparsity=0.0),
    LayerSpec("conv2", m=729, k=2400, n=256, act_sparsity=0.39),
    LayerSpec("conv3", m=169, k=2304, n=384, act_sparsity=0.52),
    LayerSpec("conv4", m=169, k=3456, n=384, act_sparsity=0.62),
    LayerSpec("conv5", m=169, k=3456, n=256, act_sparsity=0.63),
    LayerSpec("fc6", m=1, k=9216, n=4096, act_sparsity=0.65),
    LayerSpec("fc7", m=1, k=4096, n=4096, act_sparsity=0.71),
    LayerSpec("fc8", m=1, k=4096, n=1000, act_sparsity=0.73),
)

# Per-benchmark average dynamic feature sparsity (paper Fig. 2/4 bands).
BENCH_SPARSITY = {
    "cifar10": 0.49,
    "alexnet": 0.36,
    "vgg16": 0.45,
    "resnet50": 0.40,
    "googlenet": 0.42,
    "deepcomp-alexnet": 0.36,  # + static weight sparsity below
}
DEEPCOMP_WEIGHT_SPARSITY = {  # paper Fig. 2: 18%-85% across layers
    "conv1": 0.18, "conv2": 0.62, "conv3": 0.65, "conv4": 0.63,
    "conv5": 0.63, "fc6": 0.85, "fc7": 0.85, "fc8": 0.74,
}
