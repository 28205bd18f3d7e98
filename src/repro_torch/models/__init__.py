"""The model: every family's training forward over a flat parameter
vector (the BERT encoder, the dense, MoE, Mamba-1 SSM and Jamba hybrid
decoders, the audio and VLM input stubs), at tp = 1 or over a model axis
with tensor, sequence and expert parallelism (``common.ParallelCtx``),
and the decoders' prefill and KV-cached decode (tp = 1); the small CIFAR
ResNet and DCGAN of the paper's Sec. 7.2 and 7.3 (``resnet``,
``dcgan``)."""
from repro_torch.models.dcgan import (d_loss, discriminator, g_loss,
                                      generator, init_discriminator,
                                      init_generator, synthetic_faces)
from repro_torch.models.resnet import (init_resnet, resnet_apply,
                                       resnet_loss, synthetic_cifar)

__all__ = ["d_loss", "discriminator", "g_loss", "generator",
           "init_discriminator", "init_generator", "synthetic_faces",
           "init_resnet", "resnet_apply", "resnet_loss", "synthetic_cifar"]
