"""The data plane: record files and their native (C++) loader with image
augmentation, the byte-level BPE tokenizer and the importers, the device
prefetch, and the synthetic datasets (numpy, NHWC images). The JAX
package's ``data`` names, from the port's modules."""

from distributed_tensorflow_guide_tpu_torch.data.native_loader import (  # noqa: F401
    Field,
    ImageAugment,
    NativeRecordLoader,
    PyRecordLoader,
    make_fields,
    open_record_loader,
    write_records,
)
from distributed_tensorflow_guide_tpu_torch.data.importers import (  # noqa: F401
    MNIST_FIELDS,
    decode_mnist_batch,
    import_idx_pair,
    import_mnist,
    read_idx,
    write_idx,
)
from distributed_tensorflow_guide_tpu_torch.data.prefetch import (  # noqa: F401
    DevicePrefetchIterator,
    PrefetchStats,
    pack_batches,
    pack_stream,
    prefetch_to_device,
)
from distributed_tensorflow_guide_tpu_torch.data.synthetic import (  # noqa: F401
    SyntheticClassification,
    SyntheticCTR,
    synthetic_imagenet,
    synthetic_mnist,
)
from distributed_tensorflow_guide_tpu_torch.data.tokenizer import (  # noqa: F401
    ByteBPETokenizer,
    ByteTokenizer,
    import_labeled_text,
    import_text,
    labeled_text_fields,
    text_fields,
)
