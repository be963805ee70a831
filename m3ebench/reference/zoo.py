"""Frozen plain copy of the paper's DNN model zoo (Section VI-A1) as
layer lists, and of the task builder that interleaves a task's models
into a dependency-free job group (Section III).

A configuration file names its task's models; ``job_group`` builds the
group of ``group_size`` jobs that a group-layout seed gives, the same
jobs in the same order as the program's ``build_task_groups``.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Sequence

import numpy as np

from m3ebench.reference.costmodel import (Layer, attention_fcs, conv2d,
                                          dwconv2d, fc)

VISION_N = 16
LANG_SEQ = 128
RECOM_B = 8


def _repeat(layers: List[Layer], times: int) -> List[Layer]:
    return [l for _ in range(times) for l in layers]


def resnet50() -> List[Layer]:
    N = VISION_N
    ls = [conv2d(N, 64, 3, 112, 112, 7, 7, 2)]
    for K, mid, Y, blocks in [(256, 64, 56, 3), (512, 128, 28, 4),
                              (1024, 256, 14, 6), (2048, 512, 7, 3)]:
        ls += _repeat([conv2d(N, mid, K, Y, Y, 1, 1),
                       conv2d(N, mid, mid, Y, Y, 3, 3),
                       conv2d(N, K, mid, Y, Y, 1, 1)], blocks)
    ls.append(fc(N, 1000, 2048))
    return ls


def mobilenetv2() -> List[Layer]:
    N = VISION_N
    ls = [conv2d(N, 32, 3, 112, 112, 3, 3, 2)]
    for cin, cout, e, Y, blocks in [(32, 16, 1, 112, 1), (16, 24, 6, 56, 2),
                                    (24, 32, 6, 28, 3), (32, 64, 6, 14, 4),
                                    (64, 96, 6, 14, 3), (96, 160, 6, 7, 3),
                                    (160, 320, 6, 7, 1)]:
        ls += _repeat([conv2d(N, cin * e, cin, Y, Y, 1, 1),
                       dwconv2d(N, cin * e, Y, Y, 3, 3),
                       conv2d(N, cout, cin * e, Y, Y, 1, 1)], blocks)
    ls += [conv2d(N, 1280, 320, 7, 7, 1, 1), fc(N, 1000, 1280)]
    return ls


def shufflenet() -> List[Layer]:
    N = VISION_N
    ls = [conv2d(N, 24, 3, 56, 56, 3, 3, 2)]
    for C, Y, blocks in [(116, 28, 4), (232, 14, 8), (464, 7, 4)]:
        ls += _repeat([conv2d(N, C // 2, C // 2, Y, Y, 1, 1),
                       dwconv2d(N, C // 2, Y, Y, 3, 3),
                       conv2d(N, C // 2, C // 2, Y, Y, 1, 1)], blocks)
    ls += [conv2d(N, 1024, 464, 7, 7, 1, 1), fc(N, 1000, 1024)]
    return ls


def vgg16() -> List[Layer]:
    N = VISION_N
    ls: List[Layer] = []
    for C, K, Y, blocks in [(3, 64, 224, 1), (64, 64, 224, 1),
                            (64, 128, 112, 2), (128, 256, 56, 3),
                            (256, 512, 28, 3), (512, 512, 14, 3)]:
        ls += _repeat([conv2d(N, K, max(C, K // 2), Y, Y, 3, 3)], blocks)
    ls += [fc(N, 4096, 25088), fc(N, 4096, 4096), fc(N, 1000, 4096)]
    return ls


def mnasnet() -> List[Layer]:
    N = VISION_N
    ls = [conv2d(N, 32, 3, 112, 112, 3, 3, 2)]
    for i, (cin, cout, e, Y, blocks) in enumerate(
            [(32, 24, 3, 56, 3), (24, 40, 3, 28, 3), (40, 80, 6, 14, 3),
             (80, 112, 6, 14, 2), (112, 160, 6, 7, 3)]):
        k = 5 if i % 2 else 3
        ls += _repeat([conv2d(N, cin * e, cin, Y, Y, 1, 1),
                       dwconv2d(N, cin * e, Y, Y, k, k),
                       conv2d(N, cout, cin * e, Y, Y, 1, 1)], blocks)
    ls.append(fc(N, 1000, 1280))
    return ls


def gpt2() -> List[Layer]:
    return [l for _ in range(12)
            for l in attention_fcs(LANG_SEQ, 768, 12, d_ff=3072)]


def mobilebert() -> List[Layer]:
    ls: List[Layer] = []
    for _ in range(24):
        ls += attention_fcs(LANG_SEQ, 128, 4, d_ff=512)
        ls += [fc(LANG_SEQ, 512, 128), fc(LANG_SEQ, 128, 512)]
    return ls


def transformerxl() -> List[Layer]:
    ls: List[Layer] = []
    for _ in range(16):
        ls += attention_fcs(LANG_SEQ, 512, 8, d_ff=2048)
        ls.append(fc(LANG_SEQ * 8, LANG_SEQ, 64))
    return ls


def bert_base() -> List[Layer]:
    return gpt2()


def alphagozero() -> List[Layer]:
    N = VISION_N
    ls = [conv2d(N, 256, 17, 19, 19, 3, 3)]
    for _ in range(20):
        ls += [conv2d(N, 256, 256, 19, 19, 3, 3),
               conv2d(N, 256, 256, 19, 19, 3, 3)]
    ls += [conv2d(N, 2, 256, 19, 19, 1, 1), fc(N, 362, 2 * 19 * 19),
           conv2d(N, 1, 256, 19, 19, 1, 1), fc(N, 256, 19 * 19),
           fc(N, 1, 256)]
    return ls


def deepspeech2() -> List[Layer]:
    T = LANG_SEQ
    ls = [conv2d(1, 32, 1, T, 41, 11, 41, 2),
          conv2d(1, 32, 32, T, 21, 11, 21, 1)]
    d_in, d_h = 32 * 21, 800
    for i in range(5):
        for _ in ("fw", "bw"):
            ls += [fc(T, 3 * d_h, d_in if i == 0 else 2 * d_h),
                   fc(T, 3 * d_h, d_h)]
    ls.append(fc(T, 29, 2 * d_h))
    return ls


def fasterrcnn() -> List[Layer]:
    N = VISION_N
    ls = resnet50()[:-1]
    ls += [conv2d(N, 512, 2048, 14, 14, 3, 3),
           conv2d(N, 18, 512, 14, 14, 1, 1),
           conv2d(N, 36, 512, 14, 14, 1, 1),
           fc(128, 1024, 7 * 7 * 256), fc(128, 1024, 1024),
           fc(128, 91, 1024), fc(128, 364, 1024)]
    return ls


def transformer() -> List[Layer]:
    ls: List[Layer] = []
    for _ in range(6):
        ls += attention_fcs(LANG_SEQ, 512, 8, d_ff=2048)
    for _ in range(6):
        ls += attention_fcs(LANG_SEQ, 512, 8, d_ff=2048)
        ls += attention_fcs(LANG_SEQ, 512, 8)
    return ls


def dlrm() -> List[Layer]:
    B = RECOM_B
    return [fc(B, 512, 13), fc(B, 256, 512), fc(B, 64, 256),
            fc(B, 512, 512), fc(B, 256, 512), fc(B, 1, 256)]


def widedeep() -> List[Layer]:
    B = RECOM_B
    return [fc(B, 1024, 512), fc(B, 512, 1024), fc(B, 256, 512),
            fc(B, 1, 1024), fc(B, 1, 256)]


def ncf() -> List[Layer]:
    B = RECOM_B
    return [fc(B, 256, 128), fc(B, 128, 256), fc(B, 64, 128),
            fc(B, 64, 64), fc(B, 1, 128)]


def din() -> List[Layer]:
    B = RECOM_B
    return [fc(B, 80, 144), fc(B, 40, 80), fc(B, 1, 40),
            fc(B, 200, 288), fc(B, 80, 200), fc(B, 2, 80)]


MODELS: Dict[str, Callable[[], List[Layer]]] = {
    "resnet50": resnet50, "mobilenetv2": mobilenetv2,
    "shufflenet": shufflenet, "vgg16": vgg16, "mnasnet": mnasnet,
    "gpt2": gpt2, "mobilebert": mobilebert, "transformerxl": transformerxl,
    "bert_base": bert_base, "alphagozero": alphagozero,
    "deepspeech2": deepspeech2, "fasterrcnn": fasterrcnn,
    "transformer": transformer, "dlrm": dlrm, "widedeep": widedeep,
    "ncf": ncf, "din": din,
}


def job_group(models: Sequence[str], group_size: int,
              seed: int) -> List[Layer]:
    """The first group of ``group_size`` jobs: the models' layer streams
    interleaved round robin, each stream started at a layer drawn from
    ``numpy.random.default_rng(seed)`` in model order."""
    rng = np.random.default_rng(seed)
    streams = []
    for m in models:
        layers = MODELS[m]()
        start = int(rng.integers(0, len(layers)))
        streams.append(itertools.cycle(layers[start:] + layers[:start]))
    return [next(streams[i % len(streams)]) for i in range(group_size)]
