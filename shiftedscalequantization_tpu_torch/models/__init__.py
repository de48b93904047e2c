from . import resnet
