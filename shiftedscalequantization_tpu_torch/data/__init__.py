from .datasets import ArrayLoader, build_cifar10_data, build_imagenet_data
