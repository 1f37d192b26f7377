"""Host-side IO (mirror of compv_tpu.io): images, video, the camera
abstraction, EXIF and serialization. Frames are numpy u8 arrays on the
host; ``torch.from_numpy(frame).to(device)`` takes one to the card."""
from compv_tpu_torch.io.image_io import (  # noqa: F401
    read_image, write_image, read_raw, write_raw, parse_raw_filename,
)
from compv_tpu_torch.io.video import (  # noqa: F401
    VideoReader, open_video, RawYuvReader, ImageSequenceReader, GifReader,
    FfmpegReader, VideoWriterRaw,
)
from compv_tpu_torch.io.camera import (  # noqa: F401
    Camera, VideoFileCamera, SyntheticCamera, list_devices,
)
from compv_tpu_torch.io.exif import (  # noqa: F401
    ExifData, read_exif, orientation_to_transform,
)
from compv_tpu_torch.io.serialize import (  # noqa: F401
    array_from_json, array_to_json, load_checkpoint, load_mat_json,
    load_npz, save_checkpoint, save_mat_json, save_npz,
)
