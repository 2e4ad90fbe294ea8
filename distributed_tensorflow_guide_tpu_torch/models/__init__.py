"""The models: the Transformer (LM and classifier, with the routed MoE
FFN) and its generator, the Switch LM (``moe_lm``), ResNet, the MNIST CNN
and Wide&Deep."""
