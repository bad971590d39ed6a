"""YOLOv7, the person detector of the dataset build's mask stage."""
