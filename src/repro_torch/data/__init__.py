from repro_torch.data.digits import (  # noqa: F401
    DOMAINS, IMAGE_SHAPE, NUM_CLASSES, DigitDataset, make_domain_dataset,
    make_mixture, render_digit, render_images,
)
from repro_torch.data.partition import (  # noqa: F401
    DeviceData, assign_label_ratios, build_network, dirichlet_label_split,
    interpolate_features, iterate_minibatches, make_device, reveal_labels,
)
from repro_torch.data.lm_stream import LMStream, LMStreamConfig  # noqa: F401
