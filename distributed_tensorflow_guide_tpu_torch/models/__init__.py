"""The models: the Transformer (LM and classifier) and its generator,
ResNet, the MNIST CNN and Wide&Deep."""
