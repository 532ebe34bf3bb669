"""sopro_tpu_torch: Sopro TTS in PyTorch for NVIDIA Hopper.

A port of `sopro_tpu` (JAX) that imports neither JAX nor `sopro_tpu`. Plain
tensor code is PyTorch; the five kernels (the AR decode loop K1 and its
one-step form K5, NAR heads+argmax K2, the SEANet vocoder for whole
utterances K3 and for stream chunks K4) are CUDA C++ under `csrc/`, built
with nvcc at first use and bound through ctypes (`kernels.py`).

`SoproTTS` (from_pretrained / from_random, synthesize, stream, batch) is
imported on first access; importing this package loads only the
configuration classes. Serving is `sopro_tpu_torch.serve`, the command line
`python -m sopro_tpu_torch.cli`, training `sopro_tpu_torch.train` (data
parallel: `sopro_tpu_torch.parallel`).
"""

from sopro_tpu_torch.config import RuntimeConfig, SoproTTSConfig

__version__ = "1.5.0"

__all__ = ["SoproTTS", "SoproTTSConfig", "RuntimeConfig", "__version__"]


def __getattr__(name):
    if name == "SoproTTS":
        from sopro_tpu_torch.tts import SoproTTS

        return SoproTTS
    raise AttributeError(name)
