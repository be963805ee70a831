"""The paper's DNN model zoo as layer-descriptor lists.

Section VI-A1: Vision (MobileNetV2, ResNet50, ShuffleNet, VGG16, MNASNet,
SqueezeNet, ...), Language (GPT-2, MobileBERT, TransformerXL, BERT, ...),
Recommendation (DLRM, Wide&Deep, NCF, DIN, ...).

Each model is a coarse list of its *distinct* layer shapes with repeat
counts — a job is a mini-batch of one layer, so only the layer's loop dims
matter.  Embedding lookups are kept on the host (Section II-A) and never
become jobs.  Mini-batch sizes follow the paper's batched-job framing:
vision N=16 images, language seq=128 tokens, recommendation batch=8
(calibrated so the per-job latency/BW orderings match the paper's Fig. 7:
vision highest latency / lowest BW, recommendation the reverse).
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.costmodel.layers import LayerDesc, attention_fcs, conv2d, dwconv2d, fc

VISION_N = 16
LANG_SEQ = 128
RECOM_B = 8


def _repeat(layers: List[LayerDesc], times: int) -> List[LayerDesc]:
    return [l for _ in range(times) for l in layers]


# --------------------------------------------------------------------------
# Vision
# --------------------------------------------------------------------------
def resnet50() -> List[LayerDesc]:
    N = VISION_N
    ls: List[LayerDesc] = [conv2d("stem", N, 64, 3, 112, 112, 7, 7, 2)]
    # (out, mid, spatial, blocks)
    for i, (K, mid, Y, blocks) in enumerate(
            [(256, 64, 56, 3), (512, 128, 28, 4),
             (1024, 256, 14, 6), (2048, 512, 7, 3)]):
        block = [
            conv2d(f"s{i}.c1", N, mid, K, Y, Y, 1, 1),
            conv2d(f"s{i}.c2", N, mid, mid, Y, Y, 3, 3),
            conv2d(f"s{i}.c3", N, K, mid, Y, Y, 1, 1),
        ]
        ls += _repeat(block, blocks)
    ls.append(fc("head", N, 1000, 2048))
    return ls


def mobilenetv2() -> List[LayerDesc]:
    N = VISION_N
    ls: List[LayerDesc] = [conv2d("stem", N, 32, 3, 112, 112, 3, 3, 2)]
    # (in, out, expand, spatial, blocks)
    cfg = [(32, 16, 1, 112, 1), (16, 24, 6, 56, 2), (24, 32, 6, 28, 3),
           (32, 64, 6, 14, 4), (64, 96, 6, 14, 3), (96, 160, 6, 7, 3),
           (160, 320, 6, 7, 1)]
    for i, (cin, cout, e, Y, blocks) in enumerate(cfg):
        block = [
            conv2d(f"b{i}.expand", N, cin * e, cin, Y, Y, 1, 1),
            dwconv2d(f"b{i}.dw", N, cin * e, Y, Y, 3, 3),
            conv2d(f"b{i}.project", N, cout, cin * e, Y, Y, 1, 1),
        ]
        ls += _repeat(block, blocks)
    ls += [conv2d("head_conv", N, 1280, 320, 7, 7, 1, 1),
           fc("head", N, 1000, 1280)]
    return ls


def shufflenet() -> List[LayerDesc]:
    N = VISION_N
    ls: List[LayerDesc] = [conv2d("stem", N, 24, 3, 56, 56, 3, 3, 2)]
    for i, (C, Y, blocks) in enumerate([(116, 28, 4), (232, 14, 8), (464, 7, 4)]):
        block = [
            conv2d(f"s{i}.pw1", N, C // 2, C // 2, Y, Y, 1, 1),
            dwconv2d(f"s{i}.dw", N, C // 2, Y, Y, 3, 3),
            conv2d(f"s{i}.pw2", N, C // 2, C // 2, Y, Y, 1, 1),
        ]
        ls += _repeat(block, blocks)
    ls += [conv2d("head_conv", N, 1024, 464, 7, 7, 1, 1),
           fc("head", N, 1000, 1024)]
    return ls


def vgg16() -> List[LayerDesc]:
    N = VISION_N
    ls: List[LayerDesc] = []
    for i, (C, K, Y, blocks) in enumerate(
            [(3, 64, 224, 1), (64, 64, 224, 1), (64, 128, 112, 2),
             (128, 256, 56, 3), (256, 512, 28, 3), (512, 512, 14, 3)]):
        ls += _repeat([conv2d(f"c{i}", N, K, max(C, K // 2), Y, Y, 3, 3)], blocks)
    ls += [fc("fc1", N, 4096, 25088), fc("fc2", N, 4096, 4096),
           fc("fc3", N, 1000, 4096)]
    return ls


def mnasnet() -> List[LayerDesc]:
    N = VISION_N
    ls: List[LayerDesc] = [conv2d("stem", N, 32, 3, 112, 112, 3, 3, 2)]
    cfg = [(32, 24, 3, 56, 3), (24, 40, 3, 28, 3), (40, 80, 6, 14, 3),
           (80, 112, 6, 14, 2), (112, 160, 6, 7, 3)]
    for i, (cin, cout, e, Y, blocks) in enumerate(cfg):
        block = [
            conv2d(f"b{i}.expand", N, cin * e, cin, Y, Y, 1, 1),
            dwconv2d(f"b{i}.dw", N, cin * e, Y, Y, 5 if i % 2 else 3, 5 if i % 2 else 3),
            conv2d(f"b{i}.project", N, cout, cin * e, Y, Y, 1, 1),
        ]
        ls += _repeat(block, blocks)
    ls.append(fc("head", N, 1000, 1280))
    return ls


# --------------------------------------------------------------------------
# Language (attention/MLP as FC bags; Section II-A)
# --------------------------------------------------------------------------
def gpt2() -> List[LayerDesc]:
    ls: List[LayerDesc] = []
    for i in range(12):
        ls += attention_fcs(f"L{i}", LANG_SEQ, 768, 12, d_ff=3072)
    return ls


def mobilebert() -> List[LayerDesc]:
    ls: List[LayerDesc] = []
    for i in range(24):
        # bottlenecked blocks: tiny 128-dim attention + stacked 512 FFNs
        ls += attention_fcs(f"L{i}", LANG_SEQ, 128, 4, d_ff=512)
        ls += [fc(f"L{i}.ffn2_in", LANG_SEQ, 512, 128),
               fc(f"L{i}.ffn2_out", LANG_SEQ, 128, 512)]
    return ls


def transformerxl() -> List[LayerDesc]:
    ls: List[LayerDesc] = []
    for i in range(16):
        # memory-augmented attention: keys/values over 2x segment length
        ls += attention_fcs(f"L{i}", LANG_SEQ, 512, 8, d_ff=2048)
        ls.append(fc(f"L{i}.mem_scores", LANG_SEQ * 8, LANG_SEQ, 64))
    return ls


def bert_base() -> List[LayerDesc]:
    ls: List[LayerDesc] = []
    for i in range(12):
        ls += attention_fcs(f"L{i}", LANG_SEQ, 768, 12, d_ff=3072)
    return ls


# --------------------------------------------------------------------------
# Streaming heavy/light mixes (HERALD / MAGMA multi-DNN serving workloads:
# AlphaGoZero, DeepSpeech2, FasterRCNN, Transformer join NCF + ResNet50)
# --------------------------------------------------------------------------
def alphagozero() -> List[LayerDesc]:
    """20-block residual tower: 256-channel 3x3 convs on the 19x19 board.
    Compute-heavy, tiny activations — the canonical 'heavy' job source."""
    N = VISION_N
    ls: List[LayerDesc] = [conv2d("stem", N, 256, 17, 19, 19, 3, 3)]
    for i in range(20):
        ls += [conv2d(f"b{i}.c1", N, 256, 256, 19, 19, 3, 3),
               conv2d(f"b{i}.c2", N, 256, 256, 19, 19, 3, 3)]
    ls += [conv2d("policy_conv", N, 2, 256, 19, 19, 1, 1),
           fc("policy_fc", N, 362, 2 * 19 * 19),
           conv2d("value_conv", N, 1, 256, 19, 19, 1, 1),
           fc("value_fc1", N, 256, 19 * 19), fc("value_fc2", N, 1, 256)]
    return ls


def deepspeech2() -> List[LayerDesc]:
    """2D conv frontend + bidirectional GRU stack (GRUs as FC bags over the
    time axis, Section II-A style) + CTC head.  BW-hungry, light compute."""
    T = LANG_SEQ                       # spectrogram frames after striding
    ls: List[LayerDesc] = [
        conv2d("conv1", 1, 32, 1, T, 41, 11, 41, 2),
        conv2d("conv2", 1, 32, 32, T, 21, 11, 21, 1),
    ]
    d_in, d_h = 32 * 21, 800
    for i in range(5):
        # one bidirectional GRU layer = 2 directions x (input + recurrent)
        # gate GEMMs, each producing 3 gates of width d_h
        for dr in ("fw", "bw"):
            ls += [fc(f"gru{i}.{dr}.x", T, 3 * d_h, d_in if i == 0 else 2 * d_h),
                   fc(f"gru{i}.{dr}.h", T, 3 * d_h, d_h)]
    ls.append(fc("ctc_head", T, 29, 2 * d_h))
    return ls


def fasterrcnn() -> List[LayerDesc]:
    """ResNet50 backbone + RPN + RoI detection head (paper's FasterRCNN)."""
    N = VISION_N
    ls = resnet50()[:-1]               # backbone sans the classifier head
    ls += [conv2d("rpn.conv", N, 512, 2048, 14, 14, 3, 3),
           conv2d("rpn.cls", N, 18, 512, 14, 14, 1, 1),
           conv2d("rpn.box", N, 36, 512, 14, 14, 1, 1),
           # RoI head over 128 proposals of 7x7x256 pooled features
           fc("roi.fc1", 128, 1024, 7 * 7 * 256),
           fc("roi.fc2", 128, 1024, 1024),
           fc("roi.cls", 128, 91, 1024), fc("roi.box", 128, 364, 1024)]
    return ls


def transformer() -> List[LayerDesc]:
    """Transformer-base (6 encoder + 6 decoder layers, d=512, h=8)."""
    ls: List[LayerDesc] = []
    for i in range(6):
        ls += attention_fcs(f"enc{i}", LANG_SEQ, 512, 8, d_ff=2048)
    for i in range(6):
        # decoder: self-attention + cross-attention + FFN (two FC bags)
        ls += attention_fcs(f"dec{i}.self", LANG_SEQ, 512, 8, d_ff=2048)
        ls += attention_fcs(f"dec{i}.cross", LANG_SEQ, 512, 8)
    return ls


# --------------------------------------------------------------------------
# Recommendation (MLPs over large batches; embeddings stay on host)
# --------------------------------------------------------------------------
def dlrm() -> List[LayerDesc]:
    B = RECOM_B
    return [fc("bot1", B, 512, 13), fc("bot2", B, 256, 512),
            fc("bot3", B, 64, 256),
            fc("top1", B, 512, 512), fc("top2", B, 256, 512),
            fc("top3", B, 1, 256)]


def widedeep() -> List[LayerDesc]:
    B = RECOM_B
    return [fc("deep1", B, 1024, 512), fc("deep2", B, 512, 1024),
            fc("deep3", B, 256, 512), fc("wide", B, 1, 1024),
            fc("head", B, 1, 256)]


def ncf() -> List[LayerDesc]:
    B = RECOM_B
    return [fc("mlp1", B, 256, 128), fc("mlp2", B, 128, 256),
            fc("mlp3", B, 64, 128), fc("gmf", B, 64, 64),
            fc("head", B, 1, 128)]


def din() -> List[LayerDesc]:
    B = RECOM_B
    return [fc("attn1", B, 80, 144), fc("attn2", B, 40, 80),
            fc("attn3", B, 1, 40),
            fc("mlp1", B, 200, 288), fc("mlp2", B, 80, 200),
            fc("head", B, 2, 80)]


MODEL_ZOO = {
    # vision
    "resnet50": resnet50, "mobilenetv2": mobilenetv2, "shufflenet": shufflenet,
    "vgg16": vgg16, "mnasnet": mnasnet,
    # language
    "gpt2": gpt2, "mobilebert": mobilebert, "transformerxl": transformerxl,
    "bert_base": bert_base,
    # streaming heavy/light workloads
    "alphagozero": alphagozero, "deepspeech2": deepspeech2,
    "fasterrcnn": fasterrcnn, "transformer": transformer,
    # recommendation
    "dlrm": dlrm, "widedeep": widedeep, "ncf": ncf, "din": din,
}

TASK_MODELS = {
    "Vision": ["resnet50", "mobilenetv2", "shufflenet", "vgg16", "mnasnet"],
    "Lang": ["gpt2", "mobilebert", "transformerxl", "bert_base"],
    "Recom": ["dlrm", "widedeep", "ncf", "din"],
    "Mix": ["resnet50", "mobilenetv2", "shufflenet",
            "gpt2", "mobilebert", "transformerxl",
            "dlrm", "widedeep", "ncf"],
    # streaming arrival mixes (repro.stream): the HERALD/MAGMA serving
    # lineup split into compute-heavy and BW-light job sources
    "Heavy": ["alphagozero", "fasterrcnn", "resnet50"],
    "Light": ["deepspeech2", "ncf", "transformer"],
    "HeavyLight": ["alphagozero", "fasterrcnn", "resnet50",
                   "deepspeech2", "ncf", "transformer"],
}


def model_layers(name: str) -> List[LayerDesc]:
    return MODEL_ZOO[name]()
