% VOT toolkit (MATLAB) integration of pytracking_tpu_torch, the PyTorch port.
% Drop this file into your VOT workspace's tracker directory and fill in
% the three paths below; the MATLAB toolkit then drives the tracker over
% the TraX protocol of pytracking_tpu_torch/evaluation/vot.py on the CUDA
% card.

% Path to the python interpreter of the environment with torch
python_path = 'PATH_TO_ENV/bin/python';

% Path to the repository root (the directory containing pytracking_tpu_torch/)
pytracking_tpu_torch_path = 'PATH_TO_PYTRACKING_TPU_TORCH';

% Path to the trax installation shipped with the VOT toolkit. See
% https://trax.readthedocs.io/en/latest/tutorial_compiling.html
trax_path = 'PATH_TO_VOT_TOOLKIT/native/trax';

tracker_name = 'dimp';          % Tracker family (pytracking_tpu_torch/trackers/)
runfile_name = 'dimp18_vot18';  % Parameter module (pytracking_tpu_torch/parameter/dimp/)
debug = 0;

%%
tracker_label = [tracker_name, '_', runfile_name];

% The python command: run_vot is the polygon protocol of VOT2018/19
% (pytracking_tpu_torch/evaluation/vot.py); VOT2020+ mask workspaces use
% the trackers.ini `traxpython` route (run_vot2020) instead.
tracker_command = sprintf(['%s -c "import sys; sys.path.append(''%s'');', ...
                           'sys.path.append(''%s/support/python'');', ...
                           'from pytracking_tpu_torch import run_vot;', ...
                           'run_vot.run_vot(''%s'', ''%s'')"'],...
                           python_path, pytracking_tpu_torch_path, trax_path, ...
                           tracker_name, runfile_name);

tracker_interpreter = python_path;

tracker_linkpath = {[trax_path, '/build'],...
		[trax_path, '/build/support/client'],...
		[trax_path, '/build/support/opencv']};
