"""The benchmark's plain reference: a path tracer in plain PyTorch with
the semantics of the reference renderer (src/render.cpp, pathtracer.hpp,
shape.hpp, bxdf.hpp, camera.hpp) and the keyed hash the port draws its
samples from, so that the same seeds give the same paths.

It imports nothing of the program. It builds the scene, the tables, the
camera rays and the target again from the inputs the benchmark hands both
sides (a configuration file and the seeds), traces the paths with every
ray's live set compacted bounce by bounce, and evaluates images and
gradients from the per-bounce residuals: a path does not depend on the
albedo or emission tables (the bounce directions, the roulette and the
hits do not read them), so one geometry pass serves every table.
"""
