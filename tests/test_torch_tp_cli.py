"""The CLI on the model axis, on the CPU: `train ppo --session.mesh.model 2`
(a process whose 2 gloo ranks are its children), 2 iterations; stopped
after 1 and resumed, it ends with the uninterrupted run's checkpoint bit
for bit, whose learner is whole (the kernels and their moments gathered
over the model ranks); the checkpoint resumes on one device, as the
reference's does, bit for bit a one-device trainer given the same state;
`eval` takes the learner on one device (tests/test_torch_mesh_cli.py's
check)."""

from test_torch_mesh_cli import check_resume_and_eval


def test_model_axis_run_resumes_bit_for_bit_and_evaluates(tmp_path, monkeypatch):
    check_resume_and_eval(tmp_path, monkeypatch, ["--session.mesh.model", "2"],
                          {"data": 1, "model": 2, "time": 1, "zero": False})
