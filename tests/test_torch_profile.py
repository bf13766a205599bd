"""The train-step profile reads its stages from the ranges the step opens:
one tiny-fixture step on the CPU must show every stage of the DAF step."""

import importlib
import pathlib

PORT_PKG = 'unsupervised_domain_adaptation_object_detection_implementation_tpu_torch'
ROOT = pathlib.Path(__file__).resolve().parent.parent

profile_train = importlib.import_module(f'{PORT_PKG}.tools.profile_train')


def test_profile_train_reads_every_stage_of_the_step(tmp_path):
    result = profile_train.main([
        '--device', 'cpu', '--size', '64', '96', '--steps', '1',
        '--config', str(ROOT / 'configs/da/faster_rcnn_r18_tiny_fixture.py'),
        '--out', str(tmp_path / 'profile.json')])
    assert list(result['stage_host_ms']) == [
        'trunk_and_grl_heads', 'rpn_head_and_loss', 'proposals',
        'roi_sampling', 'roi_align_fwd', 'bbox_head_and_loss', 'da_losses',
        'backward', 'sgd_guard_ema']
    assert all(ms > 0 for ms in result['stage_host_ms'].values())
    # the stages lie inside the profiled step
    assert sum(result['stage_host_ms'].values()) <= \
        result['profiled_wall_ms']
    assert (tmp_path / 'profile.json').exists()
