from .gen_mot_dataset import (
    gen_single_frame_dataset, prepare_multiframe_dataset,
    prepare_multiframe_scenes, process_obstacles,
)
