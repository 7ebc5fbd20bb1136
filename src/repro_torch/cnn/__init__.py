from repro_torch.cnn.zoo import (  # noqa: F401
    build_cnn, vgg16_conv, yolov2, yolov3, resnet, efficientnet_b1,
    retinanet, CNN_BUILDERS)
