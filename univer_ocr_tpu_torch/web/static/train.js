/* Training dashboard client: plain-WebSocket JSON protocol carrying the
   reference's event vocabulary (message / info / progress_tracker with
   reset, generating_data, training, validating, epoch, train_iteration,
   val_iteration, disable/enable_status_update, forward_backward —
   templates/train.html:193-263 of the reference). */
(function () {
  var ws = new WebSocket('ws://' + location.host + '/train-ws');
  var log = document.getElementById('log');
  var layerInfo = {};
  var layerOrder = [];
  var updateStatus = true;
  var bars = {
    epoch: {current: 0, total: 1},
    train: {current: 0, total: 1},
    val: {current: 0, total: 1}
  };

  function touch(name) {
    if (!layerInfo[name]) {
      layerInfo[name] = {};
      layerOrder.push(name);
    }
    return layerInfo[name];
  }

  function setStep(text, cls) {
    var el = document.getElementById('step');
    el.textContent = text;
    el.className = 'step' + (cls ? ' ' + cls : '');
  }

  function updateBars() {
    // reference layout: one bar split into train(blue)+val(green)
    // segments over the combined iteration count, epochs bar below
    var itersTotal = bars.train.total + bars.val.total;
    document.getElementById('train-bar').style.width =
      (itersTotal ? 100 * bars.train.current / itersTotal : 0) + '%';
    document.getElementById('val-bar').style.width =
      (itersTotal ? 100 * bars.val.current / itersTotal : 0) + '%';
    document.getElementById('epoch-bar').style.width =
      (bars.epoch.total ? 100 * bars.epoch.current / bars.epoch.total : 0)
      + '%';
    ['epoch', 'train', 'val'].forEach(function (k) {
      document.getElementById(k + '-label').textContent =
        bars[k].current + ' / ' + bars[k].total;
    });
    document.getElementById('progressbars').title =
      'Epochs: ' + bars.epoch.current + '/' + bars.epoch.total +
      '\nIterations (train): ' + bars.train.current + '/' + bars.train.total +
      '\nIterations (validation): ' + bars.val.current + '/' + bars.val.total;
  }

  function setBar(key, data) {
    bars[key] = {current: data.current || 0, total: data.total || 0};
    updateBars();
  }

  function appendLog(text) {
    log.value += text;
    log.scrollTop = log.scrollHeight;
  }

  function timingCell(cell, ev) {
    if (!ev || !ev.counter) {
      cell.textContent = 'False';
      cell.className = '';
      return;
    }
    cell.textContent = ev.time + (ev.counter > 1 ? ' x' + ev.counter : '');
    cell.className = ev.done ? 'done' : '';
  }

  function rebuildTable() {
    var table = document.getElementById('layer-table');
    while (table.rows.length > 1) table.deleteRow(1);
    layerOrder.forEach(function (name) {
      var info = layerInfo[name];
      var row = table.insertRow(-1);
      row.insertCell(-1).textContent = name;
      var shapes = row.insertCell(-1);
      (info.shapes || []).forEach(function (s, i) {
        if (i) shapes.appendChild(document.createElement('br'));
        shapes.appendChild(document.createTextNode(s));
      });
      row.insertCell(-1).textContent = info.rf || '';
      timingCell(row.insertCell(-1), info.forward);
      timingCell(row.insertCell(-1), info.backward);
    });
  }

  function resetStatus() {
    layerOrder.forEach(function (name) {
      delete layerInfo[name].forward;
      delete layerInfo[name].backward;
    });
    rebuildTable();
  }

  ws.onmessage = function (e) {
    var msg = JSON.parse(e.data);
    var data = msg.data;
    if (msg.event === 'message') {
      appendLog(typeof data === 'string' ? data : JSON.stringify(data));
    } else if (msg.event === 'info') {
      (data.layer_names || []).forEach(touch);
      Object.keys(data.output_shapes || {}).forEach(function (name) {
        touch(name).shapes = data.output_shapes[name];
      });
      Object.keys(data.receptive_fields || {}).forEach(function (name) {
        touch(name).rf = data.receptive_fields[name];
      });
      rebuildTable();
    } else if (msg.event === 'progress_tracker') {
      var type = data.type;
      var payload = data.data || data;
      if (type === 'reset') resetStatus();
      else if (type === 'generating_data') setStep('Generating data', 'warn');
      else if (type === 'training') setStep('Training', 'primary');
      else if (type === 'validating') setStep('Validating', 'success');
      else if (type === 'epoch') setBar('epoch', payload);
      else if (type === 'train_iteration') setBar('train', payload);
      else if (type === 'val_iteration') setBar('val', payload);
      else if (type === 'disable_status_update') updateStatus = false;
      else if (type === 'enable_status_update') updateStatus = true;
      else if (type === 'forward_backward') {
        if (!updateStatus) return;
        Object.keys(data.data || {}).forEach(function (name) {
          var events = data.data[name];
          var info = touch(name);
          if (events.forward) info.forward = events.forward;
          if (events.backward) info.backward = events.backward;
        });
        rebuildTable();
      } else {
        appendLog(JSON.stringify(payload) + '\n');
      }
    } else if (msg.event === 'stopped') {
      setStep('stopped', '');
    }
  };

  document.getElementById('start').onclick = function () {
    appendLog(new Array(81).join('=') + '\n\n');
    ws.send(JSON.stringify({event: 'start', data: {
      use_gpu: document.getElementById('use_gpu').checked}}));
    setStep('starting...', '');
  };
  document.getElementById('clear').onclick = function () {
    setStep('', '');
    bars = {epoch: {current: 0, total: 1},
            train: {current: 0, total: 1},
            val: {current: 0, total: 1}};
    updateBars();
    layerInfo = {};
    layerOrder = [];
    rebuildTable();
    log.value = '';
  };
  document.getElementById('stop').onclick = function () {
    ws.send(JSON.stringify({event: 'stop'}));
  };
})();
