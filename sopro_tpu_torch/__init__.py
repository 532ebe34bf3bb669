"""sopro_tpu_torch: the Sopro TTS inference path in PyTorch for NVIDIA Hopper.

A port of `sopro_tpu` (JAX) that imports neither JAX nor `sopro_tpu`. Plain
tensor code is PyTorch; the four kernels on the synthesize and stream paths
(AR decode loop, NAR heads+argmax, SEANet vocoder for whole utterances and
for stream chunks) are CUDA C++ under `csrc/`, built with nvcc at first use
and bound through ctypes (`kernels.py`).

Import `sopro_tpu_torch.tts` for the `SoproTTS` facade; this package module
itself imports nothing heavy.
"""

__all__ = ["SoproTTS"]


def __getattr__(name):
    if name == "SoproTTS":
        from sopro_tpu_torch.tts import SoproTTS

        return SoproTTS
    raise AttributeError(name)
