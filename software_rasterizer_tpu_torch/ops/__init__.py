"""Device compute: the trace-space scene, camera rays and the path kernel."""
